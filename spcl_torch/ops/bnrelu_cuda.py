"""Fused BatchNorm + ReLU in train mode on float32 NCHW tensors: the kernels of
`csrc/bnrelu.cu` behind a `torch.autograd.Function`, their plain PyTorch
versions, and launch counts.

No TPU kernel is replaced: spcl_tpu leaves BatchNorm + ReLU to XLA. On the
H100 the port's plain path ran cuDNN's NCHW BatchNorm and PyTorch's ReLU
passes, at about a tenth of the byte bound; the encoder's BatchNorm took
more than half of the 2N=60 pretrain step. Eight passes over the activation
are the least the function needs in a train step (forward statistics,
forward apply read and write, backward sums read of dy and x, backward apply
read of dy and x and write of dx), and the four kernels make exactly those:

  pass           kernel in csrc/bnrelu.cu    reads, writes
  `fwd_stats`    bnrelu_fwd_stats            x
  `fwd_apply`    bnrelu_fwd_apply            x -> y
  `bwd_sums`     bnrelu_bwd_sums             dy, x
  `bwd_apply`    bnrelu_bwd_apply            dy, x -> dx

The function is `nn.BatchNorm2d`'s in train mode followed by ReLU
(`models/norm.py`, spcl_tpu's `TorchBatchNorm`): normalise with the biased
batch variance, (x - mean) * w + b with w = weight / sqrt(var + eps)
(subtract first), the running mean and variance moved with `momentum`, the
variance with Bessel's factor, `num_batches_tracked` + 1; `update=False`
(frozen statistics) leaves all three where they are. The per-channel sums
are float64 (a thread's, a block's, and the blocks' in a fixed order), the
statistics are rounded to float32 once; the apply rounds each operation in
the order written, in the kernels and in the plain versions alike. The
backward recomputes the ReLU mask from x: dz = dy where (x - mean) * w + b
> 0; dbias = sum dz, dweight = sum dz * xhat, dx = w * (dz - mean dz -
xhat * mean(dz * xhat)).

Dispatch: a CUDA tensor launches the kernels or raises; a CPU tensor takes
the plain versions. The kernels are built with nvcc at first use into
`build/spcl_torch/` (see `_build.py`). `LAUNCHES` counts each kernel launch;
`reset_launch_counts` zeroes it. The wrappers allocate outputs and scratch
with torch.empty per call; the one state kept across calls is an array of
per-channel arrival counters a device (`_tickets`), which every launch
leaves zero.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from . import _build
from ..utils.profiling import launch_counts

SOURCE = _build.CSRC_DIR / "bnrelu.cu"

PASSES = ("fwd_stats", "fwd_apply", "bwd_sums", "bwd_apply")
# kernel name -> launches since the last reset
LAUNCHES: Dict[str, int] = launch_counts(f"bnrelu_{name}" for name in PASSES)

TILE_UNITS = 4096      # float4 (or float) units of one channel a block covers
MAX_CHANNELS = 8192    # the arrival counters a device holds
_THREADS = 256         # threads of a block (bnrelu_threads() in the source)

_lib: Optional[ctypes.CDLL] = None
_TICKETS: Dict[int, torch.Tensor] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------------ build / bind
def build(verbose: bool = False) -> Tuple[Path, float, str]:
    """Compile `csrc/bnrelu.cu` with nvcc for sm_90a unless already built.
    Returns (library path, seconds spent compiling, compiler output)."""
    return _build.build_library(SOURCE, "spcl_bnrelu", verbose)


def bind(path: Path) -> ctypes.CDLL:
    """Load a library built from `csrc/bnrelu.cu` and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    p, i, u, f, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
                     ctypes.c_double)
    geo = [i, i, u, u, u, u, u, u]  # vec, C, hwu, units, tile, tiles, m, s
    lib.bnrelu_threads.argtypes = []
    lib.bnrelu_threads.restype = i
    lib.bnrelu_fwd_stats.argtypes = [p] + geo + [d] + [p] * 6 + [f, f, d, i, p]
    lib.bnrelu_fwd_apply.argtypes = [p] + geo + [p] * 4 + [p]
    lib.bnrelu_bwd_sums.argtypes = [p, p] + geo + [d] + [p] * 8 + [p]
    lib.bnrelu_bwd_apply.argtypes = [p, p] + geo + [p] * 5 + [p]
    for name in PASSES:
        getattr(lib, f"bnrelu_{name}").restype = i
    if lib.bnrelu_threads() != _THREADS:
        raise RuntimeError(f"kernel block of {lib.bnrelu_threads()} threads != {_THREADS}")
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(build()[0])
    return _lib


# ------------------------------------------------------------------ launch plan
def fast_div(d: int) -> Tuple[int, int]:
    """(m, s) with n // d == ((m * n >> 32) + n) >> s for 0 <= n < 2**31: the
    kernels' division of a unit index by the units of a row."""
    if not 0 < d < 2 ** 31:
        raise ValueError(f"divisor {d} out of range")
    s = (d - 1).bit_length()
    m = ((1 << 32) * ((1 << s) - d)) // d + 1
    return m, s


def plan(shape, vec: bool) -> Dict[str, int]:
    """The launch geometry of an [N, C, H, W] tensor: units (float4 where
    `vec`, else float) of a row and of a channel, the units a block covers
    and the blocks a channel takes."""
    n, c, h, w = shape
    hwu = h * w // 4 if vec else h * w
    units = n * hwu
    if units >= 2 ** 31 or c > MAX_CHANNELS:
        raise ValueError(f"bnrelu kernels take < 2**31 units and <= {MAX_CHANNELS} channels "
                         f"a launch, got {tuple(shape)}")
    tile = TILE_UNITS
    tiles = max(1, -(-units // tile))
    m, s = fast_div(hwu)
    return {"vec": int(vec), "C": c, "hwu": hwu, "units": units, "tile": tile,
            "tiles": tiles, "m": m, "s": s}


def _geo(p: Dict[str, int]):
    return (p["vec"], p["C"], p["hwu"], p["units"], p["tile"], p["tiles"], p["m"], p["s"])


def _vec(*tensors) -> bool:
    """16-byte units: H * W a multiple of 4 and every base 16-byte aligned."""
    h, w = tensors[0].shape[2:]
    return (h * w) % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _tickets(device) -> torch.Tensor:
    """The per-channel arrival counters on `device`: made zero once with
    torch.zeros, and zero again at the end of every launch (the last block
    of a channel resets its counter), so back-to-back calls and CUDA graph
    replays find them zero. Launches on one device share them, so they must
    not run at the same time on two streams."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    ticket = _TICKETS.get(index)
    if ticket is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("bnrelu kernels: call them once outside CUDA graph capture "
                               "first; their counters are made at the first call on a device")
        ticket = torch.zeros(MAX_CHANNELS, dtype=torch.int32, device=device)
        _TICKETS[index] = ticket
    return ticket


def _check(x: torch.Tensor, *others: torch.Tensor) -> None:
    """Checks before pointers reach a kernel: contiguous float32 NCHW tensors
    of x's shape on x's CUDA device."""
    if x.dim() != 4:
        raise ValueError(f"bnrelu kernels take NCHW tensors, got shape {tuple(x.shape)}")
    for t in (x,) + others:
        if (not t.is_cuda or t.device != x.device or t.dtype != torch.float32
                or not t.is_contiguous() or t.shape != x.shape):
            raise ValueError("bnrelu kernels take contiguous float32 NCHW tensors of one "
                             f"shape on one CUDA device; got {t.dtype} {t.device} "
                             f"{tuple(t.shape)} contiguous={t.is_contiguous()}")


def _check_channel(x: torch.Tensor, *vectors: torch.Tensor) -> None:
    c = x.shape[1]
    for v in vectors:
        if (v.device != x.device or v.dtype != torch.float32 or not v.is_contiguous()
                or v.shape[-1] != c):
            raise ValueError(f"per-channel operand {v.dtype} {v.device} {tuple(v.shape)} "
                             f"for {c} channels")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _count(x: torch.Tensor) -> float:
    return float(x.numel() // x.shape[1])


# ------------------------------------------------------------------ kernels
def fwd_stats_kernel(x, running: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                     momentum: float, eps: float, update: bool) -> torch.Tensor:
    """`fwd_stats_plain` on the card: one launch of bnrelu_fwd_stats."""
    _check(x)
    rm, rv, tracked = running
    _check_channel(x, rm, rv)
    if tracked.dtype != torch.int64 or tracked.device != x.device:
        raise ValueError(f"num_batches_tracked must be int64 on {x.device}")
    p = plan(x.shape, _vec(x))
    stats = torch.empty((2, p["C"]), dtype=torch.float32, device=x.device)
    part = torch.empty((p["C"], p["tiles"], 2), dtype=torch.float64, device=x.device)
    err = _load().bnrelu_fwd_stats(
        x.data_ptr(), *_geo(p), _count(x), part.data_ptr(), _tickets(x.device).data_ptr(),
        stats.data_ptr(), rm.data_ptr(), rv.data_ptr(), tracked.data_ptr(),
        1.0 - momentum, momentum, eps, int(update), _stream(x))
    _build.raise_on(err, "bnrelu_fwd_stats")
    LAUNCHES["bnrelu_fwd_stats"] += 1
    return stats


def fwd_apply_kernel(x, stats, weight, bias) -> torch.Tensor:
    """`fwd_apply_plain` on the card: one launch of bnrelu_fwd_apply."""
    _check(x)
    _check_channel(x, stats, weight, bias)
    y = torch.empty_like(x)
    p = plan(x.shape, _vec(x, y))
    err = _load().bnrelu_fwd_apply(x.data_ptr(), *_geo(p), stats.data_ptr(), weight.data_ptr(),
                                   bias.data_ptr(), y.data_ptr(), _stream(x))
    _build.raise_on(err, "bnrelu_fwd_apply")
    LAUNCHES["bnrelu_fwd_apply"] += 1
    return y


def bwd_sums_kernel(dy, x, stats, weight, bias):
    """`bwd_sums_plain` on the card: one launch of bnrelu_bwd_sums."""
    _check(x, dy)
    _check_channel(x, stats, weight, bias)
    p = plan(x.shape, _vec(x, dy))
    c = p["C"]
    bstats = torch.empty((2, c), dtype=torch.float32, device=x.device)
    dweight, dbias = (torch.empty(c, dtype=torch.float32, device=x.device) for _ in range(2))
    part = torch.empty((c, p["tiles"], 2), dtype=torch.float64, device=x.device)
    err = _load().bnrelu_bwd_sums(
        dy.data_ptr(), x.data_ptr(), *_geo(p), _count(x), stats.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), part.data_ptr(), _tickets(x.device).data_ptr(), bstats.data_ptr(),
        dweight.data_ptr(), dbias.data_ptr(), _stream(x))
    _build.raise_on(err, "bnrelu_bwd_sums")
    LAUNCHES["bnrelu_bwd_sums"] += 1
    return bstats, dweight, dbias


def bwd_apply_kernel(dy, x, stats, bstats, weight, bias) -> torch.Tensor:
    """`bwd_apply_plain` on the card: one launch of bnrelu_bwd_apply."""
    _check(x, dy)
    _check_channel(x, stats, bstats, weight, bias)
    dx = torch.empty_like(x)
    p = plan(x.shape, _vec(x, dy, dx))
    err = _load().bnrelu_bwd_apply(dy.data_ptr(), x.data_ptr(), *_geo(p), stats.data_ptr(),
                                   bstats.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                                   dx.data_ptr(), _stream(x))
    _build.raise_on(err, "bnrelu_bwd_apply")
    LAUNCHES["bnrelu_bwd_apply"] += 1
    return dx


# ------------------------------------------------------------------ plain versions
def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


def _pre_activation(x, stats, weight, bias):
    mean, invstd = stats[0], stats[1]
    w = weight * invstd
    return (x - _per_channel(mean)) * _per_channel(w) + _per_channel(bias)


def _xhat(x, stats):
    return (x - _per_channel(stats[0])) * _per_channel(stats[1])


@torch.no_grad()
def fwd_stats_plain(x, running: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                    momentum: float, eps: float, update: bool) -> torch.Tensor:
    """[2, C] float32 (mean, 1 / sqrt(var + eps)) of x's channels, the sums in
    float64, the variance biased; with `update` the running mean and the
    running variance (Bessel's factor) move by `momentum` and
    num_batches_tracked by 1, in place."""
    count = _count(x)
    xd = x.double()
    s = xd.sum(dim=(0, 2, 3))
    q = (xd * xd).sum(dim=(0, 2, 3))
    mean = s / count
    var = torch.clamp(q / count - mean * mean, min=0.0)
    stats = torch.stack([mean, 1.0 / torch.sqrt(var + eps)]).float()
    if update:
        rm, rv, tracked = running
        unbiased = (var * (count / (count - 1.0)) if count > 1 else var).float()
        keep = 1.0 - momentum
        rm.copy_(rm * keep + stats[0] * momentum)
        rv.copy_(rv * keep + unbiased * momentum)
        tracked.add_(1)
    return stats


def fwd_apply_plain(x, stats, weight, bias) -> torch.Tensor:
    """relu((x - mean) * w + b), each operation rounded in float32."""
    return torch.relu(_pre_activation(x, stats, weight, bias))


def bwd_sums_plain(dy, x, stats, weight, bias):
    """([2, C] (mean dz, mean dz * xhat), dweight = sum dz * xhat, dbias =
    sum dz), the sums in float64."""
    dz = torch.where(_pre_activation(x, stats, weight, bias) > 0, dy, torch.zeros_like(dy))
    s = dz.double().sum(dim=(0, 2, 3))
    q = (dz.double() * _xhat(x, stats).double()).sum(dim=(0, 2, 3))
    count = _count(x)
    return torch.stack([s / count, q / count]).float(), q.float(), s.float()


def bwd_apply_plain(dy, x, stats, bstats, weight, bias) -> torch.Tensor:
    """dx = w * (dz - mean dz - xhat * mean(dz * xhat))."""
    dz = torch.where(_pre_activation(x, stats, weight, bias) > 0, dy, torch.zeros_like(dy))
    w = weight * stats[1]
    return _per_channel(w) * ((dz - _per_channel(bstats[0]))
                              - _xhat(x, stats) * _per_channel(bstats[1]))


# ------------------------------------------------------------------ dispatch
def fwd_stats(x, running, momentum: float, eps: float, update: bool) -> torch.Tensor:
    fn = fwd_stats_kernel if x.is_cuda else fwd_stats_plain
    return fn(x, running, momentum, eps, update)


def fwd_apply(x, stats, weight, bias) -> torch.Tensor:
    return (fwd_apply_kernel if x.is_cuda else fwd_apply_plain)(x, stats, weight, bias)


def bwd_sums(dy, x, stats, weight, bias):
    return (bwd_sums_kernel if x.is_cuda else bwd_sums_plain)(dy, x, stats, weight, bias)


def bwd_apply(dy, x, stats, bstats, weight, bias) -> torch.Tensor:
    fn = bwd_apply_kernel if x.is_cuda else bwd_apply_plain
    return fn(dy, x, stats, bstats, weight, bias)


class BnRelu(torch.autograd.Function):
    """relu(batch_norm(x)) in train mode; the backward launches the sums and
    apply kernels. `running` = (running_mean, running_var,
    num_batches_tracked), moved in place when `update`."""

    @staticmethod
    def forward(ctx, x, weight, bias, running, momentum: float, eps: float, update: bool):
        stats = fwd_stats(x, running, momentum, eps, update)
        w, b = weight.detach(), bias.detach()
        y = fwd_apply(x, stats, w, b)
        ctx.save_for_backward(x, stats, w, b)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, stats, w, b = ctx.saved_tensors
        dy = dy.contiguous()
        bstats, dweight, dbias = bwd_sums(dy, x, stats, w, b)
        dx = bwd_apply(dy, x, stats, bstats, w, b) if ctx.needs_input_grad[0] else None
        return dx, dweight, dbias, None, None, None, None


def bn_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            running: Tuple[torch.Tensor, torch.Tensor, torch.Tensor], *, momentum: float,
            eps: float, update: bool = True) -> torch.Tensor:
    """relu(nn.BatchNorm2d's train-mode forward of NCHW float32 `x`), the
    running statistics moved unless `update` is False."""
    return BnRelu.apply(x, weight, bias, running, float(momentum), float(eps), bool(update))
