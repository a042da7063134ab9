"""Model FLOPs and the window-attention bound of the Swin-Unet
configurations, counted from their shapes.

FLOPs count the products of the patch embedding, every linear layer (qkv,
proj, the MLP, patch merging and expanding, the skip joins), the window
attention's q k^T and P v, the 1x1 output, the projection head and the
contrastive similarity, two a multiply-add: the forward; the backward's
weight gradient of every trained layer and input gradient of every layer
but the first (three times the forward, less the patch embedding's input
gradient); in the semi step the EMA teacher's forward. LayerNorm, GELU, the
softmax and the optimizer are left out. A step's FLOPs over its time and
the dense TF32 peak give `step.mfu_pct`.

`stage_bound_s_per_step` is the least seconds of a step's window-attention
work, whatever implements it: per block and pass, the larger of its bytes at
3.35 TB/s (forward: q, k, v read and the output written; backward: q, k, v
and the output's gradient read, dq, dk, dv written; float32) and its FLOPs
(4 N n C forward, 8 N n C backward, N tokens of C channels, n tokens a
window) at the float32 peak the kernels of `spcl_torch/ops/csrc/wattn.cu`
run at (67 TFLOP/s). It is the only per-configuration number the harness
hands a metric reader (`ctx["stage_bound_s"]`), so it carries the bound of
`swin.wattn_roofline`.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..peaks import H100
from ..reference import swin_unet as ref
from .unet import pretrain_views, semi_batches

ENCODER = ref.ENCODER


def _shape(program: Dict) -> Dict:
    s = ref.arch(program)
    s["num_classes"] = int(program["Arch"].get("num_classes", 4))
    return s


def blocks(program: Dict, until: str) -> List[Tuple[int, int, int]]:
    """(tokens a view, channels, tokens a window) of every Swin block up to
    `until` (a stage name, or "Final")."""
    s = _shape(program)
    side = s["img_size"] // int(s["patch_size"])
    ws, c, depths = int(s["window_size"]), int(s["embed_dim"]), s["depths"]
    out = []
    for i, name in enumerate(ENCODER):
        r = side // 2 ** i
        out += [(r * r, c * 2 ** i, min(ws, r) ** 2)] * int(depths[i])
        if name == until:
            return out
    for j in (2, 1, 0):
        r = side // 2 ** j
        out += [(r * r, c * 2 ** j, min(ws, r) ** 2)] * int(depths[j])
        if ref.DECODER[2 - j] == until:
            return out
    return out


def forward_flops(program: Dict, until: str) -> float:
    """A view's forward FLOPs up to `until`."""
    s = _shape(program)
    p, c = int(s["patch_size"]), int(s["embed_dim"])
    side = s["img_size"] // p
    ratio = float(s["mlp_ratio"])
    f = 2.0 * 3 * p * p * c * side * side                          # patch embedding
    f += sum((8.0 + 4.0 * ratio) * tokens * ch * ch + 4.0 * tokens * n * ch
             for tokens, ch, n in blocks(program, until))           # qkv, proj, MLP; QK^T, PV
    for i, name in enumerate(ENCODER[:-1]):
        r = side // 2 ** i
        f += 2.0 * (r * r // 4) * 4 * c * 2 ** i * 2 * c * 2 ** i  # merging
        if name == until:
            return f
    if until in ENCODER:
        return f
    for i, name in enumerate(ref.DECODER[:-1], start=1):
        j = 3 - i
        r, ch = side // 2 ** j, c * 2 ** j
        f += 2.0 * (r * r // 4) * 2 * ch * 4 * ch                   # expand into stage i
        f += 2.0 * r * r * 2 * ch * ch                              # the skip join
        if name == until:
            return f
    f += 2.0 * side * side * c * 16 * c                             # x4 expand
    f += 2.0 * (4 * side) ** 2 * c * s["num_classes"]               # 1x1 output
    return f


def _train(program: Dict, until: str) -> float:
    s = _shape(program)
    p, c = int(s["patch_size"]), int(s["embed_dim"])
    side = s["img_size"] // p
    return 3.0 * forward_flops(program, until) - 2.0 * 3 * p * p * c * side * side


def flops_per_step(config: Dict, program: Dict) -> float:
    if config["driver"] == "pretrain":
        until = program["SPInfonceParams"]["feature_names"]
        views = pretrain_views(program)
        d_in = int(_shape(program)["embed_dim"]) * min(2 ** (ENCODER.index(until) + 1), 8)
        head = 2.0 * (d_in * 256 + 256 * 256)
        loss = 2.0 * views * views * 256
        return views * (_train(program, until) + 3.0 * head) + 3.0 * loss
    n_l, n_u = semi_batches(program)
    return (n_l + 2 * n_u) * _train(program, "Final") + n_u * forward_flops(program, "Final")


def attention_bound_s(tokens: int, channels: int, n: int, views: int) -> Tuple[float, float]:
    """(forward, backward) least seconds of one block's window attention
    over `views` views."""
    elems = float(views) * tokens * channels
    fwd = max(4 * elems * 4 / H100["hbm_bytes_per_s"], 4.0 * elems * n / H100["f32_flops"])
    bwd = max(7 * elems * 4 / H100["hbm_bytes_per_s"], 8.0 * elems * n / H100["f32_flops"])
    return fwd, bwd


def stage_bound_s_per_step(config: Dict, program: Dict):
    """Least seconds of a step's window attention: forward and backward of
    every block the step trains (semi: also the teacher's forward)."""
    if config["driver"] == "pretrain":
        views = pretrain_views(program)
        return sum(sum(attention_bound_s(t, c, n, views))
                   for t, c, n in blocks(program, program["SPInfonceParams"]["feature_names"]))
    n_l, n_u = semi_batches(program)
    total = 0.0
    for t, c, n in blocks(program, "Final"):
        total += sum(attention_bound_s(t, c, n, n_l + 2 * n_u))
        total += attention_bound_s(t, c, n, n_u)[0]
    return total
