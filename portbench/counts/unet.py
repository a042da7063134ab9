"""Model FLOPs and stage-kernel bounds of the UNet configurations, counted
from their shapes.

FLOPs count the products of convolutions, linear maps and the contrastive
similarity, two a multiply-add: the forward; the backward's weight gradient
of every trained layer and input gradient of every layer but the first; the
EMA teacher's forward. The gradient cache's recomputed forward is not
counted. BatchNorm, activations, pooling and the optimizer are left out
(under 1% of the products). A step's FLOPs over its time and the dense TF32
peak give `step.mfu_pct`.

The stage-kernel bounds are the frozen copy in `stage_bounds.py`, summed
over the passes a `small_c_layout: pallas` step runs.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from . import stage_bounds

ENCODER = ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5")
_LAYERS_16 = {"Conv1": 1, "Conv2": 2, "Conv3": 4, "Conv4": 8, "Conv5": 16}


def _width(stage: str, max_channel: int) -> int:
    return _LAYERS_16[stage] * max_channel // 16


def conv_layers(max_channel: int, input_dim: int, num_classes: int, crop: int,
                until: str = "logits") -> List[Tuple[str, int, int, int, int]]:
    """(name, in channels, out channels, kernel area, output pixels) of every
    convolution up to `until` (a stage name, or "logits")."""
    out = []
    side, prev = crop, input_dim
    for i, stage in enumerate(ENCODER):
        if i:
            side //= 2
        c = _width(stage, max_channel)
        out += [(f"{stage}.0", prev, c, 9, side * side), (f"{stage}.1", c, c, 9, side * side)]
        prev = c
        if stage == until:
            return out
    for stage, skip in (("5", "Conv4"), ("4", "Conv3"), ("3", "Conv2"), ("2", "Conv1")):
        side *= 2
        c = _width(skip, max_channel)
        out += [(f"Up{stage}", prev, c, 9, side * side),
                (f"Up_conv{stage}.0", 2 * c, c, 9, side * side),
                (f"Up_conv{stage}.1", c, c, 9, side * side)]
        prev = c
    out.append(("Deconv_1x1", prev, num_classes, 1, side * side))
    return out


def forward_flops(layers) -> float:
    return float(sum(2.0 * ci * co * k * px for _, ci, co, k, px in layers))


def train_flops(layers) -> float:
    """Forward, weight gradients, and input gradients but the first layer's."""
    f = forward_flops(layers)
    return 3.0 * f - forward_flops(layers[:1])


def _arch(program: Dict):
    arch, data = program["Arch"], program["Data"]
    return (int(arch["max_channel"]), int(arch["input_dim"]), int(arch["num_classes"]),
            int(data["crop"]))


def pretrain_views(program: Dict) -> int:
    cl = program["ContrastiveLoaderParams"]
    return 2 * int(cl["scan_sample_num"]) * 3 * int(cl["partition_sample_num"])


def semi_batches(program: Dict) -> Tuple[int, int]:
    return (int(program["LabeledLoader"]["batch_size"]),
            int(program["UnlabeledLoader"]["batch_size"]))


def flops_per_step(config: Dict, program: Dict) -> float:
    mc, ind, ncls, crop = _arch(program)
    if config["driver"] == "pretrain":
        until = program["SPInfonceParams"]["feature_names"]
        views = pretrain_views(program)
        layers = conv_layers(mc, ind, ncls, crop, until)
        d_in = _width(until, mc)
        head = 2.0 * (d_in * 256 + 256 * 256)          # fc0, fc1 a view
        loss = 2.0 * views * views * 256               # the similarity matrix
        return views * (train_flops(layers) + 3.0 * head) + 3.0 * loss
    n_l, n_u = semi_batches(program)
    layers = conv_layers(mc, ind, ncls, crop)
    return (n_l + 2 * n_u) * train_flops(layers) + n_u * forward_flops(layers)


def stage_bound_s_per_step(config: Dict, program: Dict):
    """Least seconds of the stage-kernel launches of one step, or None when
    the configuration runs no stage kernel (`small_c_layout` other than
    `pallas`)."""
    if program["Arch"]["small_c_layout"] != "pallas" or config["driver"] != "semi":
        return None
    mc, ind, _, crop = _arch(program)
    c1, c2 = _width("Conv1", mc), _width("Conv2", mc)
    n_l, n_u = semi_batches(program)
    student, teacher = n_l + 2 * n_u, n_u
    total = 0.0
    # stage 1's first convolution runs in cuDNN; its kernels start at bnconv
    for b, passes1, passes2 in (
            (student, ("bnconv", "bnpool", "poolsums", "dz1", "dwprev"),
             ("conv", "bnconv", "bnpool", "poolsums", "dz1", "dwprev", "dwdx")),
            (teacher, ("bnconv", "bnpool"), ("conv", "bnconv", "bnpool"))):
        s1 = stage_bounds.stage_bounds(b, crop, crop, ind, c1, de=True)
        s2 = stage_bounds.stage_bounds(b, crop // 2, crop // 2, c1, c2, de=True)
        total += sum(s1[p] for p in passes1) + sum(s2[p] for p in passes2)
    return total
