"""On-device augmentation in PyTorch (NCHW).

The counterpart of `spcl_tpu/data/augment.py` on its gather path: resize +
rotation + flips + random crop composed into one source-coordinate map per
view, then one bilinear gather for images (nearest for labels) with zero
fill outside the canvas, plus grayscale intensity jitter (brightness then
contrast, each clamped to [0, 1]). The index math is written out exactly as
in `spcl_tpu` (`_source_coords`, `_gather_bilinear`, `_gather_nearest`), so
the same parameters give the same pixels.

Random numbers come from an explicit `torch.Generator`. Every function that
draws has a counterpart that takes the drawn values (`sample_geometric` ->
`apply_geometric`, `sample_jitter` -> `apply_jitter`, `sample_twice` ->
`augment_twice`, `flip_params` -> `apply_flip`), so a test can inject the
parameters drawn by the JAX package and compare the pixels.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch


# --------------------------------------------------------------------------- policies
@dataclass(frozen=True)
class AugmentPolicy:
    crop: int = 224
    # None: no resize. int r: torchvision Resize(r) — shortest side -> r,
    # aspect kept. (h, w): exact resize (Resize((h, w))).
    resize: Union[None, int, Tuple[int, int]] = None
    rot_degrees: float = 45.0
    # False: rotate -> flip -> crop (pretrain policies); True: crop -> rotate
    # (the reference's finetune policies rotate the cropped patch).
    rotate_after_crop: bool = False
    hflip: bool = True
    vflip: bool = True
    crop_padding: int = 0
    brightness: Tuple[float, float] = (0.5, 1.5)
    contrast: Tuple[float, float] = (0.5, 1.5)
    jitter: bool = True


# reference semi_seg/augment.py policies, op-for-op (see spcl_tpu/data/augment.py)
ACDC_PRETRAIN = AugmentPolicy(crop=224, rot_degrees=45.0, hflip=True, vflip=True,
                              brightness=(0.5, 1.5), contrast=(0.5, 1.5), jitter=True)
ACDC_LABEL = AugmentPolicy(crop=224, rot_degrees=30.0, rotate_after_crop=True,
                           hflip=False, vflip=False, jitter=False)
ACDC_VAL = AugmentPolicy(crop=224, rot_degrees=0.0, hflip=False, vflip=False, jitter=False)
PROSTATE_PRETRAIN = AugmentPolicy(crop=224, resize=224, rot_degrees=10.0,
                                  hflip=True, vflip=True, crop_padding=20,
                                  brightness=(0.9, 1.1), contrast=(0.9, 1.1), jitter=True)
PROSTATE_LABEL = AugmentPolicy(crop=224, resize=224, rot_degrees=0.0,
                               hflip=False, vflip=False, jitter=False)
PROSTATE_VAL = AugmentPolicy(crop=224, resize=224, rot_degrees=0.0,
                             hflip=False, vflip=False, jitter=False)
SPLEEN_PRETRAIN = AugmentPolicy(crop=256, resize=(256, 256), rot_degrees=10.0,
                                hflip=True, vflip=True, crop_padding=20,
                                brightness=(0.9, 1.1), contrast=(0.9, 1.1), jitter=True)
SPLEEN_LABEL = AugmentPolicy(crop=256, resize=(256, 256), rot_degrees=10.0,
                             rotate_after_crop=True, crop_padding=20,
                             hflip=False, vflip=False, jitter=False)
SPLEEN_VAL = AugmentPolicy(crop=256, resize=(256, 256), rot_degrees=0.0,
                           hflip=False, vflip=False, jitter=False)

POLICY_ZOO = {
    "acdc": {"pretrain": ACDC_PRETRAIN, "label": ACDC_LABEL, "val": ACDC_VAL},
    "prostate": {"pretrain": PROSTATE_PRETRAIN, "label": PROSTATE_LABEL, "val": PROSTATE_VAL},
    "prostate_md": {"pretrain": PROSTATE_PRETRAIN, "label": PROSTATE_LABEL, "val": PROSTATE_VAL},
    "mmwhsct": {"pretrain": ACDC_PRETRAIN, "label": ACDC_LABEL, "val": ACDC_VAL},
    "mmwhsmr": {"pretrain": ACDC_PRETRAIN, "label": ACDC_LABEL, "val": ACDC_VAL},
    "spleen": {"pretrain": SPLEEN_PRETRAIN, "label": SPLEEN_LABEL, "val": SPLEEN_VAL},
}

Params = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------- geometry
def _orig_dims(batch: int, in_size: int, sizes: Optional[torch.Tensor], device):
    """Per-sample original slice extents (float). sizes [B,2] = stored (h,w)
    of each slice inside its square canvas; None means full canvas."""
    if sizes is None:
        full = torch.full((batch,), float(in_size), dtype=torch.float32, device=device)
        return full, full
    s = sizes.to(device=device, dtype=torch.float32)
    return s[:, 0], s[:, 1]


def _frame_dims(policy: AugmentPolicy, oh: torch.Tensor, ow: torch.Tensor):
    """Resized-frame extents: Resize(int) pins the shortest side and
    truncates the long side (torchvision F.resize)."""
    if policy.resize is None:
        return oh, ow
    if isinstance(policy.resize, int):
        r = float(policy.resize)
        short = torch.minimum(oh, ow)
        rh = torch.where(oh <= ow, torch.full_like(oh, r), torch.floor(oh * r / short))
        rw = torch.where(ow <= oh, torch.full_like(ow, r), torch.floor(ow * r / short))
        return rh, rw
    rh, rw = policy.resize
    return torch.full_like(oh, float(rh)), torch.full_like(ow, float(rw))


def sample_geometric(gen: torch.Generator, batch: int, policy: AugmentPolicy,
                     in_size: int, sizes: Optional[torch.Tensor] = None,
                     device=None) -> Params:
    """Draw one view's geometry: rotation, flips and crop offsets."""
    u = torch.rand((5, batch), generator=gen, device=device)
    deg = float(policy.rot_degrees)
    theta = (u[0] * (2.0 * deg) - deg) * (math.pi / 180.0)
    fh = (u[1] < 0.5) & policy.hflip
    fv = (u[2] < 0.5) & policy.vflip
    oh, ow = _orig_dims(batch, in_size, sizes, device)
    rh, rw = _frame_dims(policy, oh, ow)
    # RandomCrop(crop, padding=p): pad every side by p, offset ~ U[0, dim+2p-crop]
    # (coordinate in the unpadded frame = offset - p). Frames smaller than the
    # crop center-pad instead.
    pad = float(policy.crop_padding)

    def _offset(uu, dim):
        span = dim + 2.0 * pad - policy.crop
        rand = torch.floor(uu * (span + 1.0)) - pad
        return torch.where(span >= 0, rand, torch.floor((dim - policy.crop) / 2.0))

    return {"theta": theta, "fh": fh, "fv": fv,
            "cy": _offset(u[3], rh), "cx": _offset(u[4], rw),
            "rh": rh, "rw": rw, "oh": oh, "ow": ow}


def _source_coords(params: Params, crop: int, in_size: int,
                   rotate_after_crop: bool = False):
    """Output-pixel -> canvas-pixel coordinates [B, crop, crop], composing the
    inverse of resize -> rotate -> flip -> crop (or resize -> flip -> crop ->
    rotate when rotate_after_crop)."""
    theta = params["theta"]
    device = theta.device
    ys = torch.arange(crop, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, ys, indexing="ij")  # [crop, crop]
    gy, gx = gy[None], gx[None]

    def col(name):
        return params[name][:, None, None]

    cos, sin = torch.cos(col("theta")), torch.sin(col("theta"))
    fh, fv = col("fh"), col("fv")
    cy, cx, rh, rw, oh, ow = (col(k) for k in ("cy", "cx", "rh", "rw", "oh", "ow"))
    if rotate_after_crop:
        # undo rotation about the CROP center, then undo crop + flips; coords
        # falling outside the materialized crop patch are fill=0
        c2 = (crop - 1) / 2.0
        dy, dx = gy - c2, gx - c2
        yc = cos * dy + sin * dx + c2
        xc = -sin * dy + cos * dx + c2
        eps = 1e-3  # tolerate float noise at exact-multiple-of-90 angles
        outside = ((yc < -eps) | (yc > crop - 1 + eps)
                   | (xc < -eps) | (xc > crop - 1 + eps))
        y = yc + cy
        x = xc + cx
        y = torch.where(fv, (rh - 1.0) - y, y)
        x = torch.where(fh, (rw - 1.0) - x, x)
        y = torch.where(outside, torch.full_like(y, -1e6), y)
        x = torch.where(outside, torch.full_like(x, -1e6), x)
    else:
        # undo crop, flips (about the frame center), then rotation
        y = gy + cy
        x = gx + cx
        y = torch.where(fv, (rh - 1.0) - y, y)
        x = torch.where(fh, (rw - 1.0) - x, x)
        ccy, ccx = (rh - 1.0) / 2.0, (rw - 1.0) / 2.0
        dy, dx = y - ccy, x - ccx
        y = cos * dy + sin * dx + ccy
        x = -sin * dy + cos * dx + ccx
    # undo resize: frame [rh, rw] -> original extent [oh, ow]
    # ((dst+0.5)*scale-0.5: PIL / torch align_corners=False convention)
    sy = (y + 0.5) * (oh / rh) - 0.5
    sx = (x + 0.5) * (ow / rw) - 0.5
    # the original extent sits centered in the canvas (packing._fit_canvas)
    return (sy + torch.floor((in_size - oh) / 2.0),
            sx + torch.floor((in_size - ow) / 2.0))


def _gather_bilinear(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """img [B, C, H, W]; sy/sx [B, h, w] float source coords; zero fill outside."""
    b, c, h, w = img.shape
    flat = img.reshape(b, c, h * w)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = (sy - y0)[:, None]
    wx = (sx - x0)[:, None]
    y0i, x0i = y0.long(), x0.long()

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = flat.gather(2, idx.reshape(b, 1, -1).expand(b, c, -1))
        return v.reshape((b, c) + sy.shape[1:]) * inside[:, None]

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)


def _gather_nearest(lab: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """lab [B, H, W] int; nearest neighbour (torch nearest-exact / PIL
    NEAREST index selection) with zero fill outside."""
    b, h, w = lab.shape
    yi = torch.floor(sy + 0.5).long()
    xi = torch.floor(sx + 0.5).long()
    inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
    v = lab.reshape(b, h * w).gather(1, idx.reshape(b, -1)).reshape(sy.shape)
    return torch.where(inside, v, torch.zeros_like(v))


def apply_geometric(image: torch.Tensor, label: Optional[torch.Tensor],
                    params: Params, crop: int, rotate_after_crop: bool = False):
    """image [B,C,H,W] bilinear; label [B,H,W] nearest — same params."""
    sy, sx = _source_coords(params, crop, image.shape[-1], rotate_after_crop)
    out_img = _gather_bilinear(image, sy, sx)
    out_lab = None if label is None else _gather_nearest(label, sy, sx)
    return out_img, out_lab


# --------------------------------------------------------------------------- intensity
def sample_jitter(gen: torch.Generator, batch: int, policy: AugmentPolicy,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample brightness and contrast factors [B]."""
    u = torch.rand((2, batch), generator=gen, device=device)
    b0, b1 = policy.brightness
    c0, c1 = policy.contrast
    return u[0] * (b1 - b0) + b0, u[1] * (c1 - c0) + c0


def apply_jitter(image: torch.Tensor, brightness: torch.Tensor,
                 contrast: torch.Tensor) -> torch.Tensor:
    """Grayscale ColorJitter parity: brightness then contrast, clamped [0,1]."""
    br = brightness.reshape(-1, 1, 1, 1)
    ct = contrast.reshape(-1, 1, 1, 1)
    x = torch.clamp(image * br, 0.0, 1.0)
    mean = torch.mean(x, dim=(1, 2, 3), keepdim=True)
    return torch.clamp((x - mean) * ct + mean, 0.0, 1.0)


# --------------------------------------------------------------------------- composed views
def sample_twice(gen: torch.Generator, batch: int, policy: AugmentPolicy,
                 in_size: int, total_freedom: bool = True,
                 sizes: Optional[torch.Tensor] = None, device=None) -> Dict:
    """Draw the parameters of two views: {"geo1", "geo2", "jitter1",
    "jitter2"}. total_freedom=False shares the geometry (reference
    SequentialWrapperTwice)."""
    p1 = sample_geometric(gen, batch, policy, in_size, sizes, device)
    p2 = sample_geometric(gen, batch, policy, in_size, sizes, device) if total_freedom else p1
    out = {"geo1": p1, "geo2": p2}
    if policy.jitter:
        out["jitter1"] = sample_jitter(gen, batch, policy, device)
        out["jitter2"] = sample_jitter(gen, batch, policy, device)
    return out


def augment_twice(image: torch.Tensor, label: Optional[torch.Tensor],
                  policy: AugmentPolicy, params: Dict):
    """Two augmented views from drawn `params` (see `sample_twice`)."""
    rac = policy.rotate_after_crop
    img1, lab1 = apply_geometric(image, label, params["geo1"], policy.crop, rac)
    img2, lab2 = apply_geometric(image, label, params["geo2"], policy.crop, rac)
    if policy.jitter:
        img1 = apply_jitter(img1, *params["jitter1"])
        img2 = apply_jitter(img2, *params["jitter2"])
    return (img1, lab1), (img2, lab2)


# --------------------------------------------------------------------------- replayable flips
def flip_params(gen: torch.Generator, n: int, threshold: float = 0.8,
                device=None) -> Params:
    """Per-sample H/V flip decisions (TensorRandomFlip(axis=[1,2], threshold)
    parity: each axis flips independently with probability `threshold`)."""
    u = torch.rand((2, n), generator=gen, device=device)
    return {"fh": u[0] < threshold, "fv": u[1] < threshold}


def apply_flip(x: torch.Tensor, params: Params) -> torch.Tensor:
    """Replay flips on [B, C, H, W] (any H, W — images, logits or features)."""
    fv = params["fv"].reshape(-1, 1, 1, 1)
    fh = params["fh"].reshape(-1, 1, 1, 1)
    x = torch.where(fv, torch.flip(x, dims=(2,)), x)
    x = torch.where(fh, torch.flip(x, dims=(3,)), x)
    return x
