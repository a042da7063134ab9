"""Plain Swin-Unet as functions of a weight dict keyed by the program's
state_dict names (`patch_embed.proj.weight`, `layers.0.blocks.1.attn.qkv.weight`,
...): `SwinTransformerSys` of github.com/HuCaoFighting/Swin-Unet (arXiv
2105.05537) with the Swin Transformer block of arXiv 2103.14030, written as
the published forward runs it: tokens [B, L, C], LayerNorm, explicit
`torch.roll` by (-shift, -shift), window partition, qkv, materialised 49 x 49
logits plus the gathered relative-position bias plus the -100 region mask,
softmax, P v, proj, window reverse, roll back, residual; patch merging,
patch expand, the x4 final expand and the 1x1 output. Float32 with TF32 off
under `ops.precision`. It imports nothing of spcl_torch.

Departures from the published code:
- the keys drop the `swin_unet.` prefix of the published `SwinUnet` wrapper,
  and the relative index and the masks are computed here, not read from the
  weights (the published state_dict holds them as buffers);
- dropout, attention dropout and drop path are 0 (the published
  configuration's stochastic depth draws random numbers no check could
  replay);
- the decoder's depths are `depths` mirrored, as the published
  `SwinTransformerSys` builds `layers_up` (its `depths_decoder` is unused).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

ENCODER = ("Swin1", "Swin2", "Swin3", "Swin4")
DECODER = ("SwinUp3", "SwinUp2", "SwinUp1", "Final")
PUBLISHED = {"embed_dim": 96, "depths": (2, 2, 2, 2), "num_heads": (3, 6, 12, 24),
             "window_size": 7, "patch_size": 4, "mlp_ratio": 4.0}


def arch(program: Dict) -> Dict:
    """The Swin-Unet shape of a program: the published one, with the Arch
    block's `embed_dim`, `num_heads` and `window_size`, at `Data.crop`."""
    a = program.get("Arch", {})
    out = dict(PUBLISHED, **{k: a[k] for k in ("embed_dim", "num_heads", "window_size")
                             if k in a})
    out["img_size"] = int(program.get("Data", {}).get("crop") or 224)
    return out


def stage_of(key: str) -> str:
    """The stage a weight belongs to."""
    parts = key.split(".")
    if parts[0] == "patch_embed":
        return "Swin1"
    if parts[0] == "layers":
        return ENCODER[int(parts[1])]
    if parts[0] == "norm":
        return "Swin4"
    if parts[0] in ("layers_up", "concat_back_dim"):
        i = int(parts[1])
        return "SwinUp3" if i <= 1 else DECODER[i - 1]
    if parts[0] in ("norm_up", "up", "output"):
        return "Final"
    raise KeyError(key)


# ------------------------------------------------------------------ published helpers
def window_partition(x, ws: int):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows, ws: int, h: int, w: int):
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def relative_position_index(ws: int):
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def attn_mask(h: int, w: int, ws: int, shift: int):
    """The published 3 x 3 region labelling of the shifted image."""
    img = torch.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    win = window_partition(img, ws).view(-1, ws * ws)
    mask = win.unsqueeze(1) - win.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


# ------------------------------------------------------------------ layers
def _ln(x, w: Dict, key: str):
    return F.layer_norm(x, x.shape[-1:], w[key + ".weight"], w[key + ".bias"], 1e-5)


def _linear(x, w: Dict, key: str):
    return F.linear(x, w[key + ".weight"], w.get(key + ".bias"))


def block(x, w: Dict, key: str, res: int, heads: int, ws: int, shift: int):
    """One Swin Transformer block on tokens [B, res^2, C]."""
    b, l, c = x.shape
    if res <= ws:
        ws, shift = res, 0
    shortcut = x
    x = _ln(x, w, key + ".norm1").view(b, res, res, c)
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    xw = window_partition(x, ws).view(-1, ws * ws, c)
    n = ws * ws
    qkv = _linear(xw, w, key + ".attn.qkv").reshape(-1, n, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    q = q * (c // heads) ** -0.5
    attn = q @ k.transpose(-2, -1)
    table = w[key + ".attn.relative_position_bias_table"]
    index = relative_position_index(ws).to(x.device)
    bias = table[index.view(-1)].view(n, n, -1).permute(2, 0, 1).contiguous()
    attn = attn + bias.unsqueeze(0)
    if shift:
        mask = attn_mask(res, res, ws, shift).to(x.device, attn.dtype)
        nw = mask.shape[0]
        attn = attn.view(-1, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = attn.softmax(dim=-1)
    xw = (attn @ v).transpose(1, 2).reshape(-1, n, c)
    xw = _linear(xw, w, key + ".attn.proj").view(-1, ws, ws, c)
    x = window_reverse(xw, ws, res, res)
    if shift:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + x.reshape(b, res * res, c)
    y = _ln(x, w, key + ".norm2")
    y = _linear(F.gelu(_linear(y, w, key + ".mlp.fc1")), w, key + ".mlp.fc2")
    return x + y


def merge(x, w: Dict, key: str, res: int):
    b, l, c = x.shape
    x = x.view(b, res, res, c)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    x = x.view(b, -1, 4 * c)
    return _linear(_ln(x, w, key + ".norm"), w, key + ".reduction")


def expand(x, w: Dict, key: str, res: int, scale: int):
    """PatchExpand (scale 2: 2 x 2 -> C / 2) or FinalPatchExpand_X4 (4 x 4 -> C)."""
    x = _linear(x, w, key + ".expand")
    b, l, c = x.shape
    out = c // (scale * scale)
    x = x.view(b, res, res, scale, scale, out).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, -1, out)
    return _ln(x, w, key + ".norm")


def _nchw(x, res: int):
    b, l, c = x.shape
    return x.view(b, res, res, c).permute(0, 3, 1, 2)


def forward(x, w: Dict, shape: Dict, until: Optional[str] = None) -> Dict:
    """{stage: NCHW features} of NCHW x up to `until` (None: all, the logits
    under "Final")."""
    ws, p = int(shape["window_size"]), int(shape["patch_size"])
    depths, heads = shape["depths"], shape["num_heads"]
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    x = F.conv2d(x, w["patch_embed.proj.weight"], w["patch_embed.proj.bias"], stride=p)
    res = x.shape[-1]
    x = _ln(x.flatten(2).transpose(1, 2), w, "patch_embed.norm")
    out, skips = {}, []
    for i, name in enumerate(ENCODER):
        skips.append(x)
        for j in range(depths[i]):
            x = block(x, w, f"layers.{i}.blocks.{j}", res, heads[i], ws, ws // 2 if j % 2 else 0)
        if i < 3:
            x = merge(x, w, f"layers.{i}.downsample", res)
            res //= 2
        else:
            x = _ln(x, w, "norm")
        out[name] = _nchw(x, res)
        if name == until:
            return out
    for i, name in enumerate(DECODER[:-1], start=1):
        if i == 1:
            x = expand(x, w, "layers_up.0", res, 2)
            res *= 2
        x = _linear(torch.cat([x, skips[3 - i]], -1), w, f"concat_back_dim.{i}")
        j = 3 - i
        for d in range(depths[j]):
            x = block(x, w, f"layers_up.{i}.blocks.{d}", res, heads[j], ws,
                      ws // 2 if d % 2 else 0)
        if i < 3:
            x = expand(x, w, f"layers_up.{i}.upsample", res, 2)
            res *= 2
        out[name] = _nchw(x, res)
        if name == until:
            return out
    x = expand(_ln(x, w, "norm_up"), w, "up", res, 4)
    out["Final"] = F.conv2d(_nchw(x, 4 * res), w["output.weight"]).float()
    return out
