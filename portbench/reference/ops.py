"""Plain building blocks of the reference: the UNet as functions of a
weight dict, the projection head, train-mode BatchNorm, the augmentation
from given draws, the losses, RAdam and the schedules.

Written from the published definitions (the contrastyou UNet and heads,
SupCon with self-paced hard weights, optax's scale_by_radam with L2 decay
before it, torchvision-style rotation, flips, crops and jitter); it imports
nothing of spcl_torch. The weight names are the reference UNet's
state_dict keys (`_Conv1.conv.0.weight`, ...) and `head.*` for the head.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

ENCODER = ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5")
BN_EPS = 1e-5


@contextlib.contextmanager
def precision(kind: str, device):
    """"float32": TF32 off for cuDNN and matmuls; "bfloat16": the control,
    every product of the step under bf16 autocast."""
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    try:
        if kind == "bfloat16":
            with torch.autocast(device_type=torch.device(device).type, dtype=torch.bfloat16):
                yield
        elif kind == "float32":
            yield
        else:
            raise ValueError(kind)
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = saved


# ------------------------------------------------------------------ model
def bn(x, w: Dict, key: str):
    return F.batch_norm(x, None, None, w[key + ".weight"], w[key + ".bias"], True, 0.0, BN_EPS)


def block(x, w: Dict, name: str):
    """(conv3x3 -> BN -> ReLU) x 2, bias-free convolutions."""
    x = F.relu(bn(F.conv2d(x, w[f"_{name}.conv.0.weight"], padding=1), w, f"_{name}.conv.1"))
    return F.relu(bn(F.conv2d(x, w[f"_{name}.conv.3.weight"], padding=1), w, f"_{name}.conv.4"))


def encoder(x, w: Dict, until: str = "Conv5"):
    """{stage: activation} of Conv1 .. `until`."""
    acts = {}
    for i, stage in enumerate(ENCODER):
        x = block(x if i == 0 else F.max_pool2d(x, 2), w, stage)
        acts[stage] = x
        if stage == until:
            break
    return acts


def unet_logits(x, w: Dict):
    """The whole UNet: encoder, nearest-upsampling decoder with skips, 1x1 logits."""
    e = encoder(x, w)
    d = e["Conv5"]
    for k, skip in (("5", "Conv4"), ("4", "Conv3"), ("3", "Conv2"), ("2", "Conv1")):
        up = F.interpolate(d, scale_factor=2, mode="nearest")
        up = F.relu(bn(F.conv2d(up, w[f"_Up{k}.up.1.weight"], padding=1), w, f"_Up{k}.up.2"))
        d = block(torch.cat([e[skip], up], dim=1), w, f"Up_conv{k}")
    return F.conv2d(d, w["_Deconv_1x1.weight"], w["_Deconv_1x1.bias"]).float()


def head(f, w: Dict):
    """Global average pool -> Linear -> leaky ReLU(0.01) -> Linear -> L2 norm."""
    x = f.float().mean(dim=(2, 3))
    x = F.linear(x, w["head.fc0.weight"], w["head.fc0.bias"])
    x = F.linear(F.leaky_relu(x, 0.01), w["head.fc1.weight"], w["head.fc1.bias"])
    x = x.float()
    return x / x.norm(dim=1, keepdim=True).clamp(min=1e-12)


# ------------------------------------------------------------------ augmentation
def flip(x, fp: Dict):
    """Flip rows of [B, C, H, W] along H where fp["fv"], then along W where fp["fh"]."""
    fv = fp["fv"].to(x.device).reshape(-1, 1, 1, 1)
    fh = fp["fh"].to(x.device).reshape(-1, 1, 1, 1)
    x = torch.where(fv, x.flip(2), x)
    return torch.where(fh, x.flip(3), x)


def _coords(geo: Dict, crop: int, rotate_after_crop: bool, device):
    """Source pixel (y, x) [B, crop, crop] of every output pixel of a
    full-canvas slice: crop at (cy, cx), flips about the frame, rotation by
    theta about the frame centre (or, after the crop, about the crop's
    centre, with what falls outside the crop masked)."""
    g = {k: v.to(device) for k, v in geo.items()}
    i = torch.arange(crop, dtype=torch.float32, device=device)
    gy, gx = i[None, :, None], i[None, None, :]
    cos, sin = torch.cos(g["theta"])[:, None, None], torch.sin(g["theta"])[:, None, None]
    rh, rw = g["rh"][:, None, None], g["rw"][:, None, None]
    fv, fh = g["fv"][:, None, None], g["fh"][:, None, None]
    inside = torch.ones((1, 1, 1), dtype=torch.bool, device=device)
    if rotate_after_crop:
        c = (crop - 1) / 2.0
        yc = cos * (gy - c) + sin * (gx - c) + c
        xc = -sin * (gy - c) + cos * (gx - c) + c
        lim = crop - 1 + 1e-3
        inside = (yc >= -1e-3) & (yc <= lim) & (xc >= -1e-3) & (xc <= lim)
        y, x = yc + g["cy"][:, None, None], xc + g["cx"][:, None, None]
        y = torch.where(fv, rh - 1 - y, y)
        x = torch.where(fh, rw - 1 - x, x)
    else:
        y, x = gy + g["cy"][:, None, None], gx + g["cx"][:, None, None]
        y = torch.where(fv, rh - 1 - y, y)
        x = torch.where(fh, rw - 1 - x, x)
        cy, cx = (rh - 1) / 2, (rw - 1) / 2
        y, x = cos * (y - cy) + sin * (x - cx) + cy, -sin * (y - cy) + cos * (x - cx) + cx
    return y, x, inside


def warp_image(img, geo: Dict, crop: int, rotate_after_crop: bool):
    """Bilinear sampling of [B, 1, H, W] at the view's source coordinates,
    zero outside the canvas."""
    b, _, h, w = img.shape
    y, x, inside = _coords(geo, crop, rotate_after_crop, img.device)
    grid = torch.stack([(2 * x + 1) / w - 1, (2 * y + 1) / h - 1], dim=-1)
    out = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    return out * inside[:, None]


def warp_label(lab, geo: Dict, crop: int, rotate_after_crop: bool):
    """Nearest sampling (half up) of [B, H, W] labels, class 0 outside."""
    b, h, w = lab.shape
    y, x, inside = _coords(geo, crop, rotate_after_crop, lab.device)
    yi, xi = torch.floor(y + 0.5).long(), torch.floor(x + 0.5).long()
    ok = inside & (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1)
    out = lab.reshape(b, -1).gather(1, idx).reshape(y.shape)
    return torch.where(ok, out, torch.zeros_like(out))


def jitter(img, brightness, contrast):
    """Brightness then contrast about the image mean, each clamped to [0, 1]."""
    x = (img * brightness.to(img.device).reshape(-1, 1, 1, 1)).clamp(0, 1)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return ((x - mean) * contrast.to(img.device).reshape(-1, 1, 1, 1) + mean).clamp(0, 1)


def view(img, geo: Dict, jit, policy: Dict):
    out = warp_image(img, geo, int(policy["crop"]), bool(policy["rotate_after_crop"]))
    return jitter(out, *jit) if policy["jitter"] else out


def gather_images(images: np.ndarray, rows: np.ndarray, device):
    """uint8 [N, H, W] rows -> float [B, 1, H, W] in [0, 1]."""
    return torch.from_numpy(images[np.asarray(rows)]).to(device)[:, None].float() / 255.0


# ------------------------------------------------------------------ losses
def self_paced_supcon(z1, z2, labels, gamma: float, temperature: float, hard: bool = True):
    """SupCon over the 2N views, positives the other views of the same
    label, each positive pair weighted by [l_ij <= gamma] (hard) or
    max(1 - l_ij / gamma, 0), l_ij = -log p_ij its NLL; the mean over rows of
    the weighted NLL sum over the row's positive count."""
    z = torch.cat([z1, z2]).float()
    lab = torch.cat([labels, labels]).to(z.device)
    n2 = z.shape[0]
    logits = z @ z.t() / temperature
    eye = torch.eye(n2, dtype=torch.bool, device=z.device)
    logits = logits.masked_fill(eye, float("-inf"))
    log_p = logits - torch.logsumexp(logits, dim=1, keepdim=True)
    pos = (lab[:, None] == lab[None, :]) & ~eye
    nll = (-log_p).masked_fill(~pos, 0.0)
    with torch.no_grad():
        w = (nll <= gamma).float() if hard else (1 - nll / gamma).clamp(min=0)
    row = (nll * w * pos).sum(dim=1) / pos.sum(dim=1).clamp(min=1)
    ok = pos.any(dim=1)
    return row[ok].mean()


def masked_ce(logits, labels, num_classes: int):
    """Pixel-mean cross-entropy of [B, C, H, W] logits (every slice valid)."""
    return F.cross_entropy(logits.float(), labels.long(), reduction="mean")


def prob_mse(student_logits, teacher_logits):
    """Mean over slices, classes and pixels of (softmax(s) - softmax(t))^2."""
    return ((student_logits.float().softmax(1) - teacher_logits.float().softmax(1)) ** 2).mean()


def dice_stats(pred, target, num_classes: int):
    """{"inter": |P_c & G_c|, "union": |P_c| + |G_c|} [B, C] of label maps."""
    p = F.one_hot(pred.long(), num_classes).float()
    g = F.one_hot(target.long(), num_classes).float()
    return {"inter": (p * g).sum(dim=(1, 2)).cpu(), "union": (p + g).sum(dim=(1, 2)).cpu()}


# ------------------------------------------------------------------ schedules, optimizer
def epoch_lr(program: Dict, epoch: int) -> float:
    """Gradual warmup x multiplier over warmup_max epochs, then cosine down
    to 1e-7 over the rest (`epoch` 1-based; epoch e uses e - 1)."""
    base = float(program["Optim"]["lr"])
    mult = float(program["Scheduler"]["multiplier"])
    warm = int(program["Scheduler"]["warmup_max"])
    t_max = max(int(program["Trainer"]["max_epoch"]) - warm, 1)
    e = max(epoch - 1, 0)
    if e < warm:
        return base * ((mult - 1.0) * e / max(warm, 1) + 1.0)
    k = min(e - warm, t_max)
    return 1e-7 + (base * mult - 1e-7) * 0.5 * (1.0 + math.cos(math.pi * k / t_max))


def epoch_gamma(program: Dict, epoch: int) -> float:
    """The self-paced age: begin + (end - begin) (e / max_epoch)^p, e = epoch - 1."""
    sp = program["SPInfonceParams"]
    t = int(program["Trainer"]["max_epoch"])
    e = min(max(epoch - 1, 0), t)
    return float(sp["begin_values"]) + (float(sp["end_values"]) - float(sp["begin_values"])) \
        * float(np.power(e / t, float(sp["p"])))


class RAdam:
    """optax.scale_by_radam (b1 0.9, b2 0.999, eps 1e-8, threshold 5) after
    L2 decay added to the gradient, then -lr; float32 step scalars."""

    def __init__(self, names: Sequence[str], wd: float):
        self.names, self.wd, self.t = list(names), float(wd), 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, w: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float):
        f32 = np.float32
        b1, b2, eps = f32(0.9), f32(0.999), 1e-8
        self.t += 1
        t = f32(self.t)
        b2t = b2 ** t
        ro_inf = f32(2) / (f32(1) - b2) - f32(1)
        ro = ro_inf - f32(2) * t * b2t / (f32(1) - b2t)
        for k in self.names:
            g = grads[k] + self.wd * w[k]
            self.mu[k] = b1 * self.mu.get(k, torch.zeros_like(g)) + (1 - b1) * g
            self.nu[k] = b2 * self.nu.get(k, torch.zeros_like(g)) + (1 - b2) * g * g
            mu_hat = self.mu[k] / float(f32(1) - b1 ** t)
            if ro >= 5:
                r = np.sqrt((ro - 4) * (ro - 2) * ro_inf / ((ro_inf - 4) * (ro_inf - 2) * ro))
                upd = float(r) * mu_hat / ((self.nu[k] / float(f32(1) - b2t)).sqrt() + eps)
            else:
                upd = mu_hat
            w[k] = w[k] - lr * upd


def ema_alpha(step: int, alpha_max: float) -> float:
    f32 = np.float32
    return float(min(f32(1) - f32(1) / (f32(step) + f32(2)), f32(alpha_max)))


def leaf_names(weights: Dict, stages: Optional[Sequence[str]], head_too: bool):
    """The trained leaves: every UNet stage in `stages` (None: all), and the head."""
    out = []
    for k in weights:
        if k.startswith("head."):
            if head_too:
                out.append(k)
        elif stages is None or k.split(".")[0].lstrip("_") in stages:
            out.append(k)
    return out
