"""Fused self-paced SupCon on CUDA: the kernels of `csrc/supcon.cu` behind a
`torch.autograd.Function`, their plain PyTorch versions, and launch counts.

Replaces `spcl_tpu/ops/supcon_pallas.py`:
  `supcon_fwd` (one kernel) <- `_denom_kernel` (:121) + `_loss_kernel` (:142)
  `supcon_bwd`              <- `_bwd_kernel` (:167)
The source note in `csrc/supcon.cu` says what they compute, what bounds them
on the H100 (3 x the product's operations over the TF32 tensor-core rate at
large 2N, launch latency at the paper's 2N = 60) and how the design handles
that: one thread-block cluster per 64 rows whose blocks split the column
sweep, products in 3xTF32 on the tensor cores, sums across the cluster in a
fixed order. `plan` reports the cluster size the kernels choose per shape.

Interface kept from the TPU module: `fwd_stats` / `bwd_dz` take independent
row and column operands (z, label, valid, global row id), so the row-strip
multi-GPU form needs only glue around them. `_prepare` pads rows to the
kernel tile with label -7, valid 0 and distinct ids; the wrapper normalizes
by the valid rows and divides by the ratio under `correct_grad`; no gradient
flows through ratio, gamma, target or valid.

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor takes
the plain version (same per-row statistics, dense). The kernels are built
with nvcc at first use into `build/spcl_torch/` (see `build`, `_build.py`).
`LAUNCHES` counts each kernel launch; `reset_launch_counts` zeroes it.

The row-strip form across ranks (`_sharded_fused`, supcon_pallas.py:401-467)
is `ShardedFusedSupCon` / `sharded_fused_self_paced_supcon`: the same two
kernels on strip operands (rows of this rank, columns of all ranks) with
`torch.distributed` collectives around them; it adds no kernel body, as the
TPU path adds none.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from . import _build
from ..utils.profiling import launch_counts
from ..parallel import mesh

_TILE = 32          # rows/cols padding of the operands (supcon_tile() in the source)
MAX_D = 256         # the largest depth the kernels take (DP in the source)
_EPS = 1e-16
_NEG_BIG = -1e30
_MODES = {"none": 0, "hard": 1, "soft": 2}

SOURCE = _build.CSRC_DIR / "supcon.cu"

# kernel name -> launches since the last reset
LAUNCHES: Dict[str, int] = launch_counts(("supcon_fwd", "supcon_bwd"))

_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------------ build / bind
def library_path() -> Path:
    return _build.library_path(SOURCE, "spcl_supcon")


def build(verbose: bool = False) -> Tuple[Path, float, str]:
    """Compile `csrc/supcon.cu` with nvcc for sm_90a unless already built.
    Returns (library path, seconds spent compiling, compiler output)."""
    return _build.build_library(SOURCE, "spcl_supcon", verbose)


def bind(path: Path) -> ctypes.CDLL:
    """Load a library built from `csrc/supcon.cu` and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.supcon_tile.argtypes = []
    lib.supcon_tile.restype = i
    lib.supcon_fwd.argtypes = [p] * 8 + [i, i, i, f, f, i] + [p] * 4 + [p]
    lib.supcon_fwd.restype = i
    lib.supcon_bwd.argtypes = [p] * 14 + [i, i, i, f, f, p, i, p, p]
    lib.supcon_bwd.restype = i
    lib.supcon_plan.argtypes = [i, i, i, i, p]
    lib.supcon_plan.restype = i
    if lib.supcon_tile() != _TILE:
        raise RuntimeError(f"kernel tile {lib.supcon_tile()} != {_TILE}")
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(build()[0])
    return _lib


def _check_operands(zr, zc, row_vecs, col_vecs, extra=()):
    """Checks before pointers reach a kernel: contiguous float32 tensors on
    one CUDA device; z [rows, D] and [cols, D] padded to the tile; one value
    per row (column) in every row (column) vector. Returns (rows, cols, D)."""
    dev = zr.get_device()  # -1 on the CPU
    for t in (zr, zc) + tuple(row_vecs) + tuple(col_vecs) + tuple(extra):
        if (dev < 0 or t.get_device() != dev or t.dtype != torch.float32
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
    if not 0 < d <= MAX_D:
        raise ValueError(f"the kernels take 0 < D <= {MAX_D}, got D = {d}")
    for n, vecs in ((rows, row_vecs), (cols, col_vecs)):
        for v in vecs:
            if tuple(v.shape) != (n,):
                raise ValueError(f"per-row vector of shape {tuple(v.shape)}, expected ({n},)")
    return rows, cols, d


def plan(kernel: str, rows: int, cols: int, d: int) -> Dict[str, int]:
    """The launch plan the kernel `kernel` ("supcon_fwd" or "supcon_bwd")
    takes at this shape on the current card: cluster size, row tiles of 64,
    column tiles per block, tiles whose s the forward keeps for pass B, the
    clusters the card holds at once, and the dynamic shared memory."""
    lib = _load()
    out = (ctypes.c_int * 7)()
    err = lib.supcon_plan({"supcon_fwd": 0, "supcon_bwd": 1}[kernel], rows, cols, d,
                          ctypes.cast(out, ctypes.c_void_p))
    _build.raise_on(err, f"{kernel} plan")
    keys = ("cluster", "row_tiles", "tiles_per_block", "kept", "active_clusters",
            "smem_bytes", "keep_max")
    return dict(zip(keys, list(out)))


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
def _kernel_z(z: torch.Tensor) -> torch.Tensor:
    """z as the kernels read it: a depth that is a multiple of 4 (zero columns
    added, which change no dot product) and 16-byte aligned rows."""
    pad = -z.shape[1] % 4
    if pad:
        return torch.nn.functional.pad(z, (0, pad))
    return z.clone() if z.data_ptr() % 16 else z


def fwd_stats_kernel(zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c,
                     inv_t: float, gamma: float, mode: str):
    """`fwd_stats_plain` on the card: one launch of supcon_fwd."""
    ops = (zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c)
    rows, cols, _ = _check_operands(zr, zc, (lab_r, val_r, gid_r), (lab_c, val_c, gid_c))
    ops = (_kernel_z(zr), _kernel_z(zc)) + ops[2:]
    d = ops[0].shape[1]
    lib = _load()
    out = torch.empty((4, rows), dtype=torch.float32, device=zr.device)
    stream = torch.cuda.current_stream(zr.device).cuda_stream
    base = out.data_ptr()
    err = lib.supcon_fwd(*(t.data_ptr() for t in ops), rows, cols, d,
                         float(inv_t), float(gamma), _MODES[mode],
                         *(base + 4 * rows * k for k in range(4)), stream)
    _build.raise_on(err, "supcon_fwd")
    LAUNCHES["supcon_fwd"] += 1
    return out.unbind(0)


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
    ops = (_kernel_z(zr), _kernel_z(zc)) + ops[2:]
    d_k = ops[0].shape[1]
    lib = _load()
    dz = torch.empty((rows, d_k), dtype=torch.float32, device=zr.device)
    stream = torch.cuda.current_stream(zr.device).cuda_stream
    err = lib.supcon_bwd(*(t.data_ptr() for t in ops), rows, cols, d_k,
                         float(inv_t), float(gamma), scale.data_ptr(), _MODES[mode],
                         dz.data_ptr(), stream)
    _build.raise_on(err, "supcon_bwd")
    LAUNCHES["supcon_bwd"] += 1
    return dz if d_k == d else dz[:, :d]


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


# ------------------------------------------------------------------ row strip (multi-GPU)
# `_sharded_fused` of the TPU module (supcon_pallas.py:401-467): each rank
# owns the rows of its local entries, [2 n_local, D], against the gathered
# columns [2N, D]. The arithmetic of one strip (`_strip_prepare`,
# `strip_forward`, `strip_loss`, `strip_backward`) takes the gathered columns
# as arguments and touches no process group, so one process can walk every
# rank's strip (`walk_strips`); `ShardedFusedSupCon` adds the collectives.
def global_order(x: torch.Tensor, world: int, n_local: int) -> torch.Tensor:
    """Rank-major rows ([view 1; view 2] of rank 0, then of rank 1, ...) ->
    the global order of the columns: view 1 of every rank, then view 2."""
    return (x.reshape((world, 2, n_local) + tuple(x.shape[1:])).transpose(0, 1)
            .reshape((2 * world * n_local,) + tuple(x.shape[1:])))


def _strip_prepare(z1, z2, target, valid, cols_z, cols_t, cols_v, row_off: int,
                   n_global: int):
    """Row (local) and column (global) operands, padded for the kernels.
    Local row r has global id row_off + r (view 1) and n_global + row_off + r
    (view 2); pad rows carry id -1 and pad columns id -2, distinct from every
    real id and both with valid 0 and label -7. Ids are float32, exact up to
    2^24 entries."""
    n_l = z1.shape[0]
    zr, tr, vr, rows_pad = _prepare(z1, z2, target, valid)
    half = torch.arange(n_l, dtype=torch.float32, device=zr.device)
    gid_r = _pad_to(torch.cat([row_off + half, n_global + row_off + half]), rows_pad, -1.0)
    cols = 2 * n_global
    cols_pad = -(-cols // _TILE) * _TILE
    zc = _pad_to(cols_z.float(), cols_pad).contiguous()
    tc = _pad_to(cols_t.float(), cols_pad, -7.0).contiguous()
    vc = _pad_to(cols_v.float(), cols_pad, 0.0).contiguous()
    ids = torch.arange(cols_pad, dtype=torch.float32, device=zr.device)
    gid_c = torch.where(ids < cols, ids, torch.full_like(ids, -2.0))
    return (zr, tr, vr, gid_r.contiguous()), (zc, tc, vc, gid_c)


def strip_forward(rows, cols, inv_t: float, gamma: float, mode: str):
    """One strip's forward: the four partial sums that add up over ranks
    (sum of row losses, valid rows with a positive, weight sum, positive
    count) and the per-row (c, denom, a) of the strip's rows."""
    (zr, tr, vr, gid_r), (zc, tc, vc, gid_c) = rows, cols
    rowloss, c, denom, a, spsum = fwd_stats(zr, zc, tr, tc, vr, vc, gid_r, gid_c,
                                            inv_t, gamma, mode)
    row_ok = ((c > 0) & (vr > 0)).float()
    parts = torch.stack([(rowloss * row_ok).sum(), row_ok.sum(),
                         (spsum * row_ok).sum(), (c * row_ok).sum()])
    return parts, (c, denom, a)


def strip_loss(parts: torch.Tensor, mode: str, correct_grad: bool):
    """(loss, ratio, m) from the four sums over all ranks."""
    m = torch.clamp(parts[1], min=1.0)
    loss = -parts[0] / m
    ratio = parts[2] / torch.clamp(parts[3], min=1.0)
    if correct_grad and mode != "none":
        loss = torch.where(ratio > 0, loss / torch.clamp(ratio, min=_EPS), loss)
    return loss, ratio, m


def column_stats(stats_rank_major: torch.Tensor, world: int, n_local: int, cols_pad: int):
    """Per-row statistics of every rank, [R * 2 n_local, 3] rank-major ->
    (c, denom, a) of the COLUMN entries in global order, padded to the
    column padding (`_gather_row_stats` of the TPU module)."""
    g = _pad_to(global_order(stats_rank_major, world, n_local), cols_pad)
    return tuple(g[:, k].contiguous() for k in range(3))


def strip_backward(rows, cols, stats_l, stats_g, g_loss, m, ratio, inv_t: float,
                   gamma: float, mode: str, correct_grad: bool, n_local: int):
    """(dz1, dz2) of the strip's rows: the row term and, through the
    columns' statistics and the symmetry of the pair terms, the column term.
    `g_loss` is the cotangent of the global loss (already summed over ranks)."""
    (zr, tr, vr, gid_r), (zc, tc, vc, gid_c) = rows, cols
    scale = g_loss / m
    if correct_grad and mode != "none":
        scale = torch.where(ratio > 0, scale / torch.clamp(ratio, min=_EPS), scale)
    dz = bwd_dz(zr, zc, tr, tc, vr, vc, gid_r, gid_c, stats_l[0], stats_g[0],
                stats_l[1], stats_g[1], stats_l[2], stats_g[2], inv_t, gamma, scale, mode)
    return dz[:n_local], dz[n_local:2 * n_local]


def walk_strips(z1, z2, target, valid, world: int, *, gamma: float,
                temperature: float = 0.07, weight_update: str = "soft",
                correct_grad: bool = False):
    """The row-strip loss of a virtual mesh of `world` ranks in ONE process:
    every rank's strip in a loop, the sums over ranks as plain additions.
    z1, z2 [N, D] and target, valid [N] are the global batch, N a multiple of
    `world`. Returns {"loss", "ratio", "m" (rows that count), "dz1", "dz2" (of
    d loss), "strips": [(rows, cols, stats_l, stats_g) per rank]}. Tests and
    chip_smoke.py hold the strip operands and results with it without a
    process group."""
    n = z1.shape[0]
    if n % world:
        raise ValueError(f"N = {n} does not divide over {world} ranks")
    n_l, inv_t = n // world, float(1.0 / float(temperature))
    z1, z2 = z1.detach(), z2.detach()
    cols_z = torch.cat([z1, z2])
    cols_t, cols_v = torch.cat([target, target]), torch.cat([valid, valid])
    operands, parts, stats = [], [], []
    for r in range(world):
        sl = slice(r * n_l, (r + 1) * n_l)
        rows, cols = _strip_prepare(z1[sl], z2[sl], target[sl], valid[sl], cols_z, cols_t,
                                    cols_v, r * n_l, n)
        p, st = strip_forward(rows, cols, inv_t, float(gamma), weight_update)
        operands.append((rows, cols))
        parts.append(p)
        stats.append(st)
    loss, ratio, m = strip_loss(torch.stack(parts).sum(dim=0), weight_update, correct_grad)
    cols_pad = operands[0][1][0].shape[0]
    stats_g = column_stats(torch.cat([torch.stack(st, dim=1)[:2 * n_l] for st in stats]),
                           world, n_l, cols_pad)
    g_loss = torch.ones((), dtype=torch.float32, device=z1.device)
    dz = [strip_backward(rows, cols, st, stats_g, g_loss, m, ratio, inv_t, float(gamma),
                         weight_update, correct_grad, n_l)
          for (rows, cols), st in zip(operands, stats)]
    return {"loss": loss, "ratio": ratio, "m": m,
            "dz1": torch.cat([d[0] for d in dz]), "dz2": torch.cat([d[1] for d in dz]),
            "strips": [(rows, cols, st, stats_g) for (rows, cols), st in zip(operands, stats)]}


class ShardedFusedSupCon(torch.autograd.Function):
    """(loss, ratio) of the self-paced SupCon over the GLOBAL batch from this
    rank's [n_local, D] views: the columns are gathered, this rank's strip
    goes through the kernels, four scalars are summed over ranks, and the
    per-row statistics are gathered for the backward's column term. The
    backward sums the loss cotangent over ranks first, as
    `_sharded_fused_bwd` does (:457), and returns the complete dL/dz of the
    local rows: no other gradient traffic."""

    @staticmethod
    def forward(ctx, z1, z2, target, valid, gamma: float, inv_t: float, mode: str,
                correct_grad: bool, group):
        world, r = mesh.world_size(group), mesh.rank(group)
        n_l, d = z1.shape
        z1, z2 = z1.detach(), z2.detach()
        # one gather: z, labels and valid travel as columns of one array
        local = torch.cat([torch.cat([z1, z2]).float(),
                           torch.cat([target, target]).float()[:, None],
                           torch.cat([valid, valid]).float()[:, None]], dim=1)
        gathered = global_order(mesh.all_gather_cat(local, group), world, n_l)
        rows, cols = _strip_prepare(z1, z2, target, valid, gathered[:, :d], gathered[:, d],
                                    gathered[:, d + 1], r * n_l, world * n_l)
        parts, stats_l = strip_forward(rows, cols, inv_t, gamma, mode)
        loss, ratio, m = strip_loss(mesh.all_reduce_sum(parts, group), mode, correct_grad)
        stats_g = column_stats(
            mesh.all_gather_cat(torch.stack(stats_l, dim=1)[:2 * n_l], group),
            world, n_l, cols[0].shape[0])
        ctx.save_for_backward(*rows, *cols, *stats_l, *stats_g, m, ratio)
        ctx.cfg = (gamma, inv_t, mode, correct_grad, n_l, z1.dtype, z2.dtype, group)
        ctx.mark_non_differentiable(ratio)
        return loss, ratio

    @staticmethod
    def backward(ctx, g_loss, g_ratio):
        t = ctx.saved_tensors
        rows, cols, stats_l, stats_g, (m, ratio) = t[0:4], t[4:8], t[8:11], t[11:14], t[14:16]
        gamma, inv_t, mode, correct_grad, n_l, dt1, dt2, group = ctx.cfg
        g_loss = mesh.all_reduce_sum(g_loss.detach(), group)
        dz1, dz2 = strip_backward(rows, cols, stats_l, stats_g, g_loss, m, ratio, inv_t,
                                  gamma, mode, correct_grad, n_l)
        return (dz1.to(dt1), dz2.to(dt2)) + (None,) * 7


def sharded_fused_self_paced_supcon(z1: torch.Tensor, z2: torch.Tensor,
                                    target: torch.Tensor, valid: torch.Tensor, *,
                                    gamma: float, temperature: float = 0.07,
                                    weight_update: str = "soft", correct_grad: bool = False,
                                    group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded fused SelfPacedSupConLoss: per-rank inputs [n_local, D] /
    [n_local]; returns (loss, ratio), identical on every rank and equal to
    the single-device loss on the gathered batch. Each rank computes only its
    [2 n_local, 2N] strip. weight_update="none" is plain SupCon. The loss
    carries 1/R of its cotangent (`parallel.mesh.grad_share`), so the ranks'
    parameter gradients SUM to the global gradient. Without a process group
    this is the single-process loss through the strip code."""
    if weight_update not in _MODES:
        raise ValueError(weight_update)
    loss, ratio = ShardedFusedSupCon.apply(
        z1, z2, target, valid.float(), float(gamma), float(1.0 / float(temperature)),
        weight_update, bool(correct_grad), group)
    return mesh.grad_share(loss, group), ratio


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
