"""Fused self-paced SupCon on CUDA: the kernels of `csrc/supcon.cu` behind a
`torch.autograd.Function`, their plain PyTorch versions, and launch counts.

Replaces `spcl_tpu/ops/supcon_pallas.py`:
  `supcon_fwd` (one kernel) <- `_denom_kernel` (:121) + `_loss_kernel` (:142)
  `supcon_bwd`              <- `_bwd_kernel` (:167)
The source note in `csrc/supcon.cu` says what they compute, what bounds them
on the H100 (float32 operations at large 2N, launch latency at the paper's
2N = 60) and how the design handles that.

Interface kept from the TPU module: `fwd_stats` / `bwd_dz` take independent
row and column operands (z, label, valid, global row id), so the row-strip
multi-GPU form needs only glue around them. `_prepare` pads rows to the
kernel tile with label -7, valid 0 and distinct ids; the wrapper normalizes
by the valid rows and divides by the ratio under `correct_grad`; no gradient
flows through ratio, gamma, target or valid.

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor takes
the plain version (same per-row statistics, dense). The kernels are built
with nvcc at first use into `build/spcl_torch/` (see `build`). `LAUNCHES`
counts each kernel launch; `reset_launch_counts` zeroes it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

_TILE = 32          # rows/cols per kernel tile (supcon_tile() in the source)
_EPS = 1e-16
_NEG_BIG = -1e30
_MODES = {"none": 0, "hard": 1, "soft": 2}

SOURCE = Path(__file__).resolve().parent / "csrc" / "supcon.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "spcl_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# kernel name -> launches since the last reset
LAUNCHES: Dict[str, int] = {"supcon_fwd": 0, "supcon_bwd": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------------ build / bind
def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    """The built library's path, keyed by the source and flags so that an
    edited source rebuilds."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libspcl_supcon_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Tuple[Path, float, str]:
    """Compile `csrc/supcon.cu` with nvcc for sm_90a unless already built.
    Returns (library path, seconds spent compiling, compiler output)."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(BUILD_DIR), suffix=".so.tmp")
    os.close(fd)
    cmd = [_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) \
        + ["-o", tmp, str(SOURCE)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.supcon_tile.argtypes = []
        lib.supcon_tile.restype = i
        lib.supcon_fwd.argtypes = [p] * 8 + [i, i, i, f, f, i] + [p] * 4 + [p]
        lib.supcon_fwd.restype = i
        lib.supcon_bwd.argtypes = [p] * 14 + [i, i, i, f, f, p, i, p, p]
        lib.supcon_bwd.restype = i
        if lib.supcon_tile() != _TILE:
            raise RuntimeError(f"kernel tile {lib.supcon_tile()} != {_TILE}")
        _lib = lib
    return _lib


def _check_operands(zr, zc, row_vecs, col_vecs, extra=()):
    """Checks before pointers reach a kernel: contiguous float32 tensors on
    one CUDA device; z [rows, D] and [cols, D] padded to the tile; one value
    per row (column) in every row (column) vector. Returns (rows, cols, D)."""
    for t in (zr, zc) + tuple(row_vecs) + tuple(col_vecs) + tuple(extra):
        if (not t.is_cuda or t.device != zr.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("supcon kernels take contiguous float32 tensors on one "
                             f"CUDA device; got {t.dtype} {t.device} "
                             f"contiguous={t.is_contiguous()}")
    if zr.dim() != 2 or zc.dim() != 2 or zc.shape[1] != zr.shape[1]:
        raise ValueError(f"z rows/cols must be [n, D]: {tuple(zr.shape)} x {tuple(zc.shape)}")
    rows, d = zr.shape
    cols = zc.shape[0]
    if rows % _TILE or cols % _TILE:
        raise ValueError(f"rows/cols must be padded to {_TILE}: {rows} x {cols}")
    for n, vecs in ((rows, row_vecs), (cols, col_vecs)):
        for v in vecs:
            if tuple(v.shape) != (n,):
                raise ValueError(f"per-row vector of shape {tuple(v.shape)}, expected ({n},)")
    return rows, cols, d


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# ------------------------------------------------------------------ plain versions
def _weights(logp: torch.Tensor, gamma: float, mode: str) -> torch.Tensor:
    if mode == "none":
        return torch.ones_like(logp)
    if mode == "hard":
        return (-logp <= gamma).float()
    return torch.clamp(1.0 + logp / gamma, min=0.0)  # soft


def _pair_terms(zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c, inv_t):
    s = (zr @ zc.T) * inv_t - inv_t
    a = (gid_c[None, :] != gid_r[:, None]).float() * val_c[None, :] * val_r[:, None]
    p = (lab_c[None, :] == lab_r[:, None]).float() * a
    e = torch.exp(torch.where(a > 0, s, torch.full_like(s, _NEG_BIG)))
    return s, p, e


def fwd_stats_plain(zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c,
                    inv_t: float, gamma: float, mode: str):
    """Per-row (denom, c, rawloss, spsum) over the dense [rows, cols] tile."""
    s, p, e = _pair_terms(zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c, inv_t)
    denom = e.sum(dim=1)
    c = p.sum(dim=1)
    logp = s - torch.log(denom + _EPS)[:, None]
    pw = p * _weights(logp, gamma, mode)
    return denom, c, (pw * logp).sum(dim=1), pw.sum(dim=1)


def bwd_dz_plain(zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c,
                 c_r, c_c, denom_r, denom_c, a_r, a_c,
                 inv_t: float, gamma: float, scale: torch.Tensor, mode: str):
    """dz for the row side: sum_j (G_ij + G_ji) z_j / T."""
    s, p, e = _pair_terms(zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c, inv_t)

    def g_side(c, denom, a_stat, valid, dim):
        def b(v):  # broadcast a per-row (dim 0) or per-column (dim 1) vector
            return v[:, None] if dim == 0 else v[None, :]
        m = (c > 0).float() * valid
        logp = s - b(torch.log(denom + _EPS))
        softmax = e / b(denom + _EPS)
        return -(b(m) * scale) * (p * _weights(logp, gamma, mode) / b(torch.clamp(c, min=1.0))
                                  - b(a_stat) * softmax)

    g = (g_side(c_r, denom_r, a_r, val_r, 0) + g_side(c_c, denom_c, a_c, val_c, 1)) * inv_t
    return g @ zc


# ------------------------------------------------------------------ kernel launches
def fwd_stats_kernel(zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c,
                     inv_t: float, gamma: float, mode: str):
    """`fwd_stats_plain` on the card: one launch of supcon_fwd."""
    ops = (zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c)
    rows, cols, d = _check_operands(zr, zc, (lab_r, val_r, gid_r), (lab_c, val_c, gid_c))
    lib = _load()
    out = torch.empty((4, rows), dtype=torch.float32, device=zr.device)
    stream = torch.cuda.current_stream(zr.device).cuda_stream
    err = lib.supcon_fwd(*(t.data_ptr() for t in ops), rows, cols, d,
                         float(inv_t), float(gamma), _MODES[mode],
                         *(out[k].data_ptr() for k in range(4)), stream)
    _raise_on(err, "supcon_fwd")
    LAUNCHES["supcon_fwd"] += 1
    return out[0], out[1], out[2], out[3]


def bwd_dz_kernel(zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c,
                  c_r, c_c, denom_r, denom_c, a_r, a_c,
                  inv_t: float, gamma: float, scale: torch.Tensor, mode: str):
    """`bwd_dz_plain` on the card: one launch of supcon_bwd. `scale` is a
    one-element device tensor (no host sync)."""
    scale = scale.reshape(1).float().contiguous()
    ops = (zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c,
           c_r, c_c, denom_r, denom_c, a_r, a_c)
    rows, cols, d = _check_operands(
        zr, zc, (lab_r, val_r, gid_r, c_r, denom_r, a_r),
        (lab_c, val_c, gid_c, c_c, denom_c, a_c), extra=(scale,))
    lib = _load()
    dz = torch.empty((rows, d), dtype=torch.float32, device=zr.device)
    stream = torch.cuda.current_stream(zr.device).cuda_stream
    err = lib.supcon_bwd(*(t.data_ptr() for t in ops), rows, cols, d,
                         float(inv_t), float(gamma), scale.data_ptr(), _MODES[mode],
                         dz.data_ptr(), stream)
    _raise_on(err, "supcon_bwd")
    LAUNCHES["supcon_bwd"] += 1
    return dz


# ------------------------------------------------------------------ dispatch
def fwd_stats(zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c,
              inv_t: float, gamma: float, mode: str):
    """Strip forward (`_fwd_stats` of the TPU module): per-ROW
    (rowloss, c, denom, a, spsum) over the (rows x cols) rectangle."""
    fn = fwd_stats_kernel if zr.is_cuda else fwd_stats_plain
    denom, c, rawloss, spsum = fn(zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c,
                                  inv_t, gamma, mode)
    c_safe = torch.clamp(c, min=1.0)
    return rawloss / c_safe, c, denom, spsum / c_safe, spsum


def bwd_dz(zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c,
           c_r, c_c, denom_r, denom_c, a_r, a_c,
           inv_t: float, gamma: float, scale: torch.Tensor, mode: str):
    """Strip backward (`_bwd_dz` of the TPU module): dz for the ROW side;
    *_c are the stats of the column entries."""
    fn = bwd_dz_kernel if zr.is_cuda else bwd_dz_plain
    return fn(zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c,
              c_r, c_c, denom_r, denom_c, a_r, a_c, inv_t, gamma, scale, mode)


def _pad_to(x: torch.Tensor, n: int, value: float = 0.0) -> torch.Tensor:
    pad = n - x.shape[0]
    if pad == 0:
        return x
    filler = torch.full((pad,) + tuple(x.shape[1:]), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, filler], dim=0)


def _prepare(z1, z2, target, valid, block: int = _TILE):
    """Concat views, cast to f32, right-pad to a `block` multiple. Pad rows
    carry label -7 (never equal to a real label), valid 0, and their own
    ids (no pad-pad diagonal hits)."""
    n = z1.shape[0]
    z = torch.cat([z1, z2], dim=0).float()
    t2 = torch.cat([target, target]).float()
    v2 = torch.cat([valid, valid]).float()
    n_pad = -(-2 * n // block) * block
    return (_pad_to(z, n_pad).contiguous(), _pad_to(t2, n_pad, -7.0).contiguous(),
            _pad_to(v2, n_pad, 0.0).contiguous(), n_pad)


class FusedSupCon(torch.autograd.Function):
    """(loss, ratio) of the fused self-paced SupCon; the backward launches
    the dz kernel. `ratio` carries no gradient."""

    @staticmethod
    def forward(ctx, z1, z2, target, valid, gamma: float, inv_t: float, mode: str,
                correct_grad: bool):
        z, t2, v2, n_pad = _prepare(z1.detach(), z2.detach(), target, valid)
        gid = torch.arange(n_pad, dtype=torch.float32, device=z.device)
        rowloss, c, denom, a, _ = fwd_stats(z, z, t2, t2, v2, v2, gid, gid,
                                            inv_t, gamma, mode)
        row_ok = ((c > 0) & (v2 > 0)).float()
        m = torch.clamp(row_ok.sum(), min=1.0)
        loss_pre = -(rowloss * row_ok).sum() / m
        spsum = a * torch.clamp(c, min=1.0)
        ratio = (spsum * row_ok).sum() / torch.clamp((c * row_ok).sum(), min=1.0)
        if correct_grad and mode != "none":
            loss = torch.where(ratio > 0, loss_pre / torch.clamp(ratio, min=_EPS), loss_pre)
        else:
            loss = loss_pre
        ctx.save_for_backward(z, t2, v2, gid, c, denom, a, m, ratio)
        ctx.cfg = (gamma, inv_t, mode, correct_grad, z1.shape[0], z1.dtype, z2.dtype)
        ctx.mark_non_differentiable(ratio)
        return loss, ratio

    @staticmethod
    def backward(ctx, g_loss, g_ratio):
        z, t2, v2, gid, c, denom, a, m, ratio = ctx.saved_tensors
        gamma, inv_t, mode, correct_grad, n, dt1, dt2 = ctx.cfg
        scale = g_loss / m
        if correct_grad and mode != "none":
            scale = torch.where(ratio > 0, scale / torch.clamp(ratio, min=_EPS), scale)
        dz = bwd_dz(z, z, t2, t2, v2, v2, gid, gid, c, c, denom, denom, a, a,
                    inv_t, gamma, scale, mode)
        return (dz[:n].to(dt1), dz[n:2 * n].to(dt2), None, None, None, None, None, None)


def fused_self_paced_supcon(z1: torch.Tensor, z2: torch.Tensor, *, gamma: float,
                            target: torch.Tensor, valid: Optional[torch.Tensor] = None,
                            temperature: float = 0.07, weight_update: str = "hard",
                            correct_grad: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused SelfPacedSupConLoss. Returns (loss, downgrade_ratio); same
    semantics as losses.supcon.self_paced_supcon_loss."""
    if weight_update not in ("hard", "soft"):
        raise ValueError(weight_update)
    if valid is None:
        valid = torch.ones(z1.shape[0], dtype=torch.float32, device=z1.device)
    return FusedSupCon.apply(z1, z2, target, valid, float(gamma),
                             float(1.0 / float(temperature)), weight_update,
                             bool(correct_grad))


def fused_supcon(z1: torch.Tensor, z2: torch.Tensor, *, target: torch.Tensor,
                 valid: Optional[torch.Tensor] = None,
                 temperature: float = 0.07) -> torch.Tensor:
    """Fused SupConLoss1 (no self-paced weighting). Returns the loss."""
    if valid is None:
        valid = torch.ones(z1.shape[0], dtype=torch.float32, device=z1.device)
    loss, _ = FusedSupCon.apply(z1, z2, target, valid, 1e9,
                                float(1.0 / float(temperature)), "none", False)
    return loss
