"""Fused small-channel encoder stage on CUDA: the kernels of
`csrc/convstage.cu` behind a `torch.autograd.Function`, their plain PyTorch
versions, and launch counts.

One stage is conv3x3 -> BN -> ReLU -> conv3x3 -> BN -> ReLU -> 2x2 max-pool
in train mode, on channels-last tensors [B, H, W, C] with C in {16, 32},
stored in float32 or bfloat16. It replaces `fused_packed_block`
(spcl_tpu/experimental/packed_block_pallas.py:611-797), whose seven Pallas
kernel bodies run through `_pc` (:595); one pass here for each:

  pass (this module)    kernel in csrc/convstage.cu   TPU kernel body
  `conv`                convstage_conv                `_k_conv`     :245
  `bnconv`              convstage_bnconv              `_k_bnconv`   :283
  `bnpool`              convstage_bnpool              `_k_bnpool`   :315
  `poolsums`            convstage_poolsums            `_k_poolsums` :346
  `dz1`                 convstage_dz1                 `_k_dz1`      :374
  `dwprev`              convstage_dwprev              `_k_dwprev`   :412
  `dwdx`                convstage_dwdx                `_k_dwdx`     :471

bfloat16 is the Pallas stage's `dtype_name="bfloat16"` (:611-613): the
activations and cotangents are stored in bf16, the operands of the products
are bf16 values (the weights, BN + ReLU of a convolution's input, dz0 in
dwdx), products accumulate in float32, and the statistics and weight
gradients come from float32 values, kept in float64 sums and returned in
float32. The plain versions round at the same points (their convolutions
run in float32 on bf16-valued operands, whose products are exact); each
kernel has a bf16 instantiation in csrc/convstage.cu, counted in
`LAUNCHES_BF16`.

The per-channel coefficient arithmetic between the passes (`bn_fwd_coef`,
`bn_bwd_coef`) is ordinary tensor code on [C] vectors, as it is XLA glue on
the TPU. With `external_first` the stage input already is z0, the output of
an ordinary convolution (stage 1: 1 -> 16 channels): `conv` and `dwdx` are
skipped, the statistics of z0 are plain sums, and the backward returns dz0.

The arithmetic is `spcl_tpu`'s, not `nn.BatchNorm2d`'s: biased variance
clamped at 0, eps 1e-5, apply as z*inv + shift (two roundings, the same in
the kernels and the plain versions, so both take the same ReLU masks from
the same inputs), ReLU mask y >= 0 in the backward, pool backward to the
first maximum in scan order, BN backward as (c0*dy + c1) + c2*z, each
operation rounded in that order (the kernels' too, so dz1 and dwdx's dz0 are
the same bits in both); cotangents of the four statistics outputs are
dropped.

Dispatch: a CUDA tensor launches the kernels or raises; a CPU tensor takes
the plain versions. The kernels are built with nvcc at first use into
`build/spcl_torch/` (see `build`, `_build.py`). `LAUNCHES` counts each kernel
launch; `reset_launch_counts` zeroes it. The wrappers allocate outputs and
scratch with torch.empty per call; the one state kept across calls is the
poolsums kernel's arrival counter, one int32 per device (`_ticket`), which
every launch leaves zero.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ..utils.profiling import launch_counts

_TILE = 16          # side of the pixel tile of one block (convstage_tile())
_CHANNELS = (16, 32)
BN_EPS = 1e-5
_BLOCKS_PER_SM = 4  # upper bound on resident blocks; sizes the partials workspace

SOURCE = _build.CSRC_DIR / "convstage.cu"

PASSES = ("conv", "bnconv", "bnpool", "poolsums", "dz1", "dwprev", "dwdx")
_DTYPES = (torch.float32, torch.bfloat16)
# kernel name -> launches since the last reset, float32 and bfloat16 apart
LAUNCHES: Dict[str, int] = launch_counts(f"convstage_{name}" for name in PASSES)
LAUNCHES_BF16: Dict[str, int] = launch_counts(f"convstage_{name}_bf16" for name in PASSES)

_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, LAUNCHES_BF16):
        for k in counts:
            counts[k] = 0


# ------------------------------------------------------------------ build / bind
def library_path() -> Path:
    return _build.library_path(SOURCE, "spcl_convstage")


def build(verbose: bool = False) -> Tuple[Path, float, str]:
    """Compile `csrc/convstage.cu` with nvcc for sm_90a unless already built.
    Returns (library path, seconds spent compiling, compiler output)."""
    return _build.build_library(SOURCE, "spcl_convstage", verbose)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.convstage_tile.argtypes = []
        lib.convstage_tile.restype = i
        # pointers, then the ints (the last one `bf`: bfloat16 activations), then the stream
        for name, n_ptr, n_int in (("conv", 5, 7), ("bnconv", 6, 6), ("bnpool", 4, 6),
                                   ("poolsums", 7, 6), ("dz1", 6, 6), ("dwprev", 9, 6),
                                   ("dwdx", 8, 7)):
            fn = getattr(lib, f"convstage_{name}")
            fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
            fn.restype = i
        lib.convstage_poolsums_plan.argtypes = [i] * 7 + [p]
        lib.convstage_poolsums_plan.restype = i
        if lib.convstage_tile() != _TILE:
            raise RuntimeError(f"kernel tile {lib.convstage_tile()} != {_TILE}")
        _lib = lib
    return _lib


def _check(tensors, *, pooled: bool = False):
    """Checks before pointers reach a kernel: contiguous [B, H, W, C] tensors
    of one dtype (float32 or bfloat16) on one CUDA device, starting on a
    16-byte boundary, with C in {16, 32} (H, W even for the pool passes).
    Returns (B, H, W) of the first tensor."""
    first = tensors[0]
    for t in tensors:
        if (not t.is_cuda or t.device != first.device or t.dtype not in _DTYPES
                or t.dtype != first.dtype or not t.is_contiguous() or t.dim() != 4):
            raise ValueError("convstage kernels take contiguous float32 or bfloat16 "
                             "[B, H, W, C] tensors of one dtype on one CUDA device; got "
                             f"{t.dtype} {t.device} {tuple(t.shape)} "
                             f"contiguous={t.is_contiguous()}")
        if t.data_ptr() % 16:
            raise ValueError("convstage kernels load 16 bytes at a time: the tensors must "
                             f"start on a 16-byte boundary, got {t.data_ptr():#x}")
        if t.shape[3] not in _CHANNELS:
            raise ValueError(f"convstage kernels are built for C in {_CHANNELS}, "
                             f"got C={t.shape[3]}")
    b, h, w, _ = first.shape
    if pooled and (h % 2 or w % 2):
        raise ValueError(f"the pool passes need even H and W, got {h} x {w}")
    return int(b), int(h), int(w)


def _check_small(t: torch.Tensor, shape, like: torch.Tensor, what: str) -> torch.Tensor:
    if (tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or t.device != like.device
            or not t.is_contiguous()):
        raise ValueError(f"{what}: expected contiguous float32 {tuple(shape)} on {like.device}, "
                         f"got {t.dtype} {tuple(t.shape)} {t.device}")
    return t


def _max_blocks(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count * _BLOCKS_PER_SM


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _bf(t: torch.Tensor) -> int:
    """The kernels' `bf` argument: 1 for bfloat16 activations, else 0."""
    return int(t.dtype == torch.bfloat16)


def _launch(name: str, like: torch.Tensor, *args) -> None:
    """One launch of convstage_`name` on `like`'s dtype (passed as `bf`, the
    argument before the stream) and its count."""
    *args, stream = args
    err = getattr(_load(), f"convstage_{name}")(*args, _bf(like), stream)
    _build.raise_on(err, f"convstage_{name}")
    if like.dtype == torch.bfloat16:
        LAUNCHES_BF16[f"convstage_{name}_bf16"] += 1
    else:
        LAUNCHES[f"convstage_{name}"] += 1


def _operand(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 weights as the products' operand in the plain versions:
    rounded to bfloat16 (and widened back, exactly) for bf16 activations,
    unchanged for float32. The kernels round them as they stage them."""
    return w if dtype == torch.float32 else w.to(dtype).float()


def _hwio_to_dw(dw64: torch.Tensor, ci: int, co: int) -> torch.Tensor:
    return dw64.reshape(3, 3, ci, co).float()


# ------------------------------------------------------------------ coefficient glue
def bn_fwd_coef(sums: torch.Tensor, n: int, gamma: torch.Tensor, beta: torch.Tensor):
    """(mean, var, coef) from float64 sums [2, C] = (sum z, sum z^2) over n
    elements per channel: biased variance clamped at 0; coef [2, C] float32 =
    (inv, shift) with inv = gamma * rsqrt(var + eps), shift = beta - mean * inv."""
    mean64 = sums[0] / n
    var64 = torch.clamp(sums[1] / n - mean64 * mean64, min=0.0)
    mean, var = mean64.float(), var64.float()
    inv = torch.rsqrt(var + BN_EPS) * gamma
    shift = beta - mean * inv
    return mean, var, torch.stack([inv, shift]).contiguous()


def bn_bwd_coef(sums_dy: torch.Tensor, n: int, mean: torch.Tensor, var: torch.Tensor,
                gamma: torch.Tensor):
    """dz = c0*dy + c1 + c2*z coefficients [3, C] float32 and (dgamma, dbeta)
    from float64 sums [2, C] = (sum dy, sum dy*z)."""
    s1, s2 = sums_dy[0], sums_dy[1]
    mean64, gamma64 = mean.double(), gamma.double()
    sigma2 = var.double() + BN_EPS
    sigma = torch.sqrt(sigma2)
    inv = gamma64 / sigma
    centered = s2 - mean64 * s1
    c2 = -inv * centered / (n * sigma2)
    c1 = -inv * s1 / n - mean64 * c2
    dcoef = torch.stack([inv, c1, c2]).float().contiguous()
    return dcoef, (centered / sigma).float(), s1.float()


def _sums(z: torch.Tensor, other: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float64 [2, C]: (sum z, sum z*other) over B, H, W (other = z if None),
    of the float32 values (a bf16 tensor's values widened exactly; the product
    of two bf16 values is exact in float32)."""
    z = z.float()
    other = z if other is None else other.float()
    return torch.stack([z.sum(dim=(0, 1, 2), dtype=torch.float64),
                        (z * other).sum(dim=(0, 1, 2), dtype=torch.float64)])


def _bn(z: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """z*inv + shift in float32 (z widened from its storage type)."""
    return z.float() * coef[0] + coef[1]


def bn_bwd(dy: torch.Tensor, z: torch.Tensor, dcoef: torch.Tensor) -> torch.Tensor:
    """The BatchNorm backward (c0*dy + c1) + c2*z in float32, each operation
    rounded in this order, as spcl_tpu writes it (`_k_dz1`, `dz_rows`) and the
    kernels form it (`bn_bwd` in csrc/convstage.cu)."""
    return dcoef[0] * dy.float() + dcoef[1] + dcoef[2] * z.float()


# ------------------------------------------------------------------ plain versions
# Each takes and returns activations in their storage type (float32 or
# bfloat16) and rounds where its kernel does; arithmetic is float32.
def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


def _oihw(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, Ci, Co] -> [Co, Ci, 3, 3]."""
    return w.permute(3, 2, 0, 1)


def _conv_grads(a: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """(d_in [B,H,W,Ci], dW [3,3,Ci,Co]) of z = conv3x3(a, w) given g = dz."""
    d_in = torch.nn.grad.conv2d_input(_nchw(a).shape, _oihw(w), _nchw(g), padding=1)
    dw = torch.nn.grad.conv2d_weight(_nchw(a), _oihw(w).shape, _nchw(g), padding=1)
    return _nhwc(d_in), dw.permute(2, 3, 1, 0).contiguous()


def conv_plain(x, w):
    """z0 = conv3x3(x, w), zero padding 1, stored in x's dtype; sums (sum z0,
    sum z0^2) of the float32 z0 before it is stored."""
    z = _nhwc(F.conv2d(_nchw(x.float()), _oihw(_operand(w, x.dtype)), padding=1))
    return z.to(x.dtype), _sums(z)


def bnconv_plain(z0, coef, w):
    """z1 = conv3x3(relu(z0*inv+shift), w), the convolution's input rounded
    to z0's dtype; sums (sum z1, sum z1^2)."""
    return conv_plain(torch.relu(_bn(z0, coef)).to(z0.dtype), w)


def _windows(t: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4, C], the four pixels of each 2x2
    window in scan order (r0,c0), (r0,c1), (r1,c0), (r1,c1)."""
    b, h, w, c = t.shape
    return t.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b, h // 2, w // 2, 4, c)


def _unwindows(t: torch.Tensor) -> torch.Tensor:
    b, hp, wp, _, c = t.shape
    return t.reshape(b, hp, wp, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b, 2 * hp, 2 * wp, c)


def bnpool_plain(z1, coef):
    """e = relu(z1*inv+shift) in z1's dtype; p = maxpool2x2(e)."""
    e = torch.relu(_bn(z1, coef)).to(z1.dtype)
    return e, _windows(e).amax(dim=3)


def _dy1(z1, coef, dp, de):
    """dy1 = (poolbwd(dp) + de) * [y1 >= 0] in float32: dp goes to the first
    maximum of each window in scan order among e = relu(y1) in z1's dtype.
    dp / de may be None (no cotangent)."""
    y = _bn(z1, coef)
    da = torch.zeros_like(y) if de is None else de.float()
    if dp is not None:
        cands = _windows(torch.relu(y).to(z1.dtype))
        is_max = cands == cands.amax(dim=3, keepdim=True)
        first = is_max & (torch.cumsum(is_max.to(torch.int32), dim=3) == 1)
        da = da + _unwindows(first.float() * dp.float()[:, :, :, None, :])
    return torch.where(y >= 0, da, torch.zeros_like(da))


def poolsums_plain(z1, coef, dp, de):
    """sums (sum dy1, sum dy1*z1)."""
    return _sums(_dy1(z1, coef, dp, de), z1)


def dz1_plain(z1, coef, dcoef, dp, de):
    """dz1 = (c0*dy1 + c1) + c2*z1, stored in z1's dtype."""
    return bn_bwd(_dy1(z1, coef, dp, de), z1, dcoef).to(z1.dtype)


def dwprev_plain(dz1, z0, coef, w):
    """dW1 = sum a0^T dz1 with a0 = relu(z0*inv+shift) recomputed (rounded to
    z0's dtype); dy0 = conv1^T(dz1) * [y0 >= 0], stored in z0's dtype; sums
    (sum dy0, sum dy0*z0) of the float32 dy0."""
    y0 = _bn(z0, coef)
    a0 = torch.relu(y0).to(z0.dtype).float()
    da0, dw = _conv_grads(a0, _operand(w, z0.dtype), dz1.float())
    dy0 = torch.where(y0 >= 0, da0, torch.zeros_like(da0))
    return dy0.to(z0.dtype), dw, _sums(dy0, z0)


def dwdx_plain(z0, dy0, dcoef, x, w):
    """dz0 = (c0*dy0 + c1) + c2*z0 (rounded to z0's dtype); dW0 = sum x^T dz0;
    dx = conv0^T(dz0), stored in x's dtype."""
    dz0 = bn_bwd(dy0, z0, dcoef).to(z0.dtype).float()
    d_in, dw = _conv_grads(x.float(), _operand(w, x.dtype), dz0)
    return d_in.to(x.dtype), dw


def float64_pass(name: str, *inputs):
    """A convolution pass (conv, bnconv, dwprev or dwdx) in float64, with its
    plain version's outputs, unrounded: the reference that the kernels' errors
    are measured against. The products' operands are those the kernel
    multiplies: for float32 activations, the inputs and what is formed from
    them in float64; for bfloat16 ones, the convolution's input formed in
    float32 as the plain version forms it and rounded to bf16 (a0 =
    relu(y0), whose ReLU mask is the float32 y0's; dz0), and the weights
    rounded to bf16."""
    *acts, w = inputs
    bf16 = acts[0].dtype == torch.bfloat16
    wd = torch.float32 if bf16 else torch.float64  # where operands are formed

    def operand(t):  # as the kernel stores it, then exact in float64
        return (t.to(torch.bfloat16) if bf16 else t).double()

    def sums(z, other):
        return torch.stack([z.sum(dim=(0, 1, 2)), (z * other).sum(dim=(0, 1, 2))])

    def conv(a):
        z = _nhwc(F.conv2d(_nchw(a), _oihw(operand(w)), padding=1))
        return z, sums(z, z)

    def y(z0, coef):
        return z0.to(wd) * coef[0].to(wd) + coef[1].to(wd)

    if name == "conv":
        return conv(acts[0].double())
    if name == "bnconv":
        return conv(operand(torch.relu(y(*acts))))
    if name == "dwprev":
        dz1, z0, coef = acts
        y0 = y(z0, coef)
        d_in, dw = _conv_grads(operand(torch.relu(y0)), operand(w), dz1.double())
        dy0 = torch.where(y0 >= 0, d_in, torch.zeros_like(d_in))
        return dy0, dw, sums(dy0, z0.double())
    z0, dy0, dcoef, x = acts
    d = dcoef.to(wd)
    dz0 = d[0] * dy0.to(wd) + d[1] + d[2] * z0.to(wd)
    return _conv_grads(x.double(), operand(w), operand(dz0))


# ------------------------------------------------------------------ kernel launches
def _weights_ok(w: torch.Tensor, ci: int, co: int, like: torch.Tensor) -> torch.Tensor:
    return _check_small(w, (3, 3, ci, co), like, "convolution weights [3, 3, Ci, Co]")


def _conv_workspace(blocks: int, co: int, device):
    return (torch.empty((blocks, 2, co), dtype=torch.float64, device=device),
            torch.empty((2, co), dtype=torch.float64, device=device))


def conv_kernel(x, w):
    """`conv_plain` on the card: one launch of convstage_conv."""
    b, h, wd = _check((x,))
    ci, co = x.shape[3], w.shape[3]
    _weights_ok(w, ci, co, x)
    blocks = _max_blocks(x.device)
    z = torch.empty((b, h, wd, co), dtype=x.dtype, device=x.device)
    partial, sums = _conv_workspace(blocks, co, x.device)
    _launch("conv", x, x.data_ptr(), w.data_ptr(), z.data_ptr(), partial.data_ptr(),
            sums.data_ptr(), b, h, wd, ci, co, blocks, _stream(x))
    return z, sums


def bnconv_kernel(z0, coef, w):
    """`bnconv_plain` on the card: one launch of convstage_bnconv."""
    b, h, wd = _check((z0,))
    c = z0.shape[3]
    _weights_ok(w, c, c, z0)
    _check_small(coef, (2, c), z0, "coef (inv, shift)")
    blocks = _max_blocks(z0.device)
    z1 = torch.empty_like(z0)
    partial, sums = _conv_workspace(blocks, c, z0.device)
    _launch("bnconv", z0, z0.data_ptr(), coef.data_ptr(), w.data_ptr(), z1.data_ptr(),
            partial.data_ptr(), sums.data_ptr(), b, h, wd, c, blocks, _stream(z0))
    return z1, sums


def bnpool_kernel(z1, coef):
    """`bnpool_plain` on the card: one launch of convstage_bnpool."""
    b, h, wd = _check((z1,), pooled=True)
    c = z1.shape[3]
    _check_small(coef, (2, c), z1, "coef (inv, shift)")
    e = torch.empty_like(z1)
    p = torch.empty((b, h // 2, wd // 2, c), dtype=z1.dtype, device=z1.device)
    _launch("bnpool", z1, z1.data_ptr(), coef.data_ptr(), e.data_ptr(), p.data_ptr(),
            b, h, wd, c, _max_blocks(z1.device) * 8, _stream(z1))
    return e, p


def _check_cotangents(z1, dp, de):
    b, h, wd = _check((z1,) + tuple(t for t in (de, dp) if t is not None), pooled=True)
    c = z1.shape[3]
    if de is not None and de.shape != z1.shape:
        raise ValueError(f"de {tuple(de.shape)} != z1 {tuple(z1.shape)}")
    if dp is not None:
        if tuple(dp.shape) != (b, h // 2, wd // 2, c) or dp.device != z1.device:
            raise ValueError(f"dp {tuple(dp.shape)} for z1 {tuple(z1.shape)}")
    return b, h, wd, c


# device index -> the poolsums kernel's arrival counter (one int32)
_TICKETS: Dict[int, torch.Tensor] = {}


def _ticket(device) -> torch.Tensor:
    """The arrival counter of convstage_poolsums on `device`: made zero once
    with torch.zeros, and zero again at the end of every launch (the block
    that adds the clusters' partials resets it), so back-to-back calls and
    CUDA graph replays find it zero. Launches on one device share it, so they
    must not run at the same time on two streams."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    ticket = _TICKETS.get(index)
    if ticket is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("poolsums_kernel: call it once outside CUDA graph capture "
                               "first; its counter is made at the first call on a device")
        ticket = torch.zeros(1, dtype=torch.int32, device=device)
        torch.cuda.current_stream(device).synchronize()
        _TICKETS[index] = ticket
    return ticket


def poolsums_plan(b: int, h: int, w: int, c: int, dp: bool, de: bool,
                  dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    """The launch of convstage_poolsums at [b, h, w, c] with dp / de present
    or absent and activations of `dtype`, on the current card: clusters,
    blocks a cluster, clusters resident at once (the float32 and bfloat16
    kernels differ), the chunks (a lane's channels of a row pair, two terms
    a channel) a float32 run holds before it is added to float64, and the
    channels a lane owns (4 in float32, 8 in bfloat16)."""
    out = (ctypes.c_int * 5)()
    err = _load().convstage_poolsums_plan(b, h, w, c, int(dp), int(de),
                                          int(dtype == torch.bfloat16),
                                          ctypes.cast(out, ctypes.c_void_p))
    _build.raise_on(err, "convstage_poolsums_plan")
    return dict(zip(("clusters", "cluster", "resident", "run", "lane_channels"), out))


def poolsums_kernel(z1, coef, dp, de):
    """`poolsums_plain` on the card: one launch of convstage_poolsums."""
    b, h, wd, c = _check_cotangents(z1, dp, de)
    _check_small(coef, (2, c), z1, "coef (inv, shift)")
    clusters = poolsums_plan(b, h, wd, c, dp is not None, de is not None,
                             z1.dtype)["clusters"]
    partial, sums = _conv_workspace(clusters, c, z1.device)
    _launch("poolsums", z1, z1.data_ptr(), coef.data_ptr(), _ptr(dp), _ptr(de),
            partial.data_ptr(), sums.data_ptr(), _ticket(z1.device).data_ptr(), b, h, wd, c,
            clusters, _stream(z1))
    return sums


def dz1_kernel(z1, coef, dcoef, dp, de):
    """`dz1_plain` on the card: one launch of convstage_dz1."""
    b, h, wd, c = _check_cotangents(z1, dp, de)
    _check_small(coef, (2, c), z1, "coef (inv, shift)")
    _check_small(dcoef, (3, c), z1, "dcoef (c0, c1, c2)")
    dz = torch.empty_like(z1)
    _launch("dz1", z1, z1.data_ptr(), coef.data_ptr(), dcoef.data_ptr(), _ptr(dp), _ptr(de),
            dz.data_ptr(), b, h, wd, c, _max_blocks(z1.device) * 8, _stream(z1))
    return dz


def dwprev_kernel(dz1, z0, coef, w):
    """`dwprev_plain` on the card: one launch of convstage_dwprev."""
    b, h, wd = _check((dz1, z0))
    c = z0.shape[3]
    if dz1.shape != z0.shape:
        raise ValueError(f"dz1 {tuple(dz1.shape)} != z0 {tuple(z0.shape)}")
    _weights_ok(w, c, c, z0)
    _check_small(coef, (2, c), z0, "coef (inv, shift)")
    dev = z0.device
    blocks = _max_blocks(dev)
    dy0 = torch.empty_like(z0)
    dw_partial = torch.empty((blocks, 9, c, c), dtype=torch.float32, device=dev)
    dw = torch.empty((9, c, c), dtype=torch.float64, device=dev)
    partial, sums = _conv_workspace(blocks, c, dev)
    _launch("dwprev", z0, dz1.data_ptr(), z0.data_ptr(), coef.data_ptr(), w.data_ptr(),
            dy0.data_ptr(), dw_partial.data_ptr(), dw.data_ptr(), partial.data_ptr(),
            sums.data_ptr(), b, h, wd, c, blocks, _stream(z0))
    return dy0, _hwio_to_dw(dw, c, c), sums


def dwdx_kernel(z0, dy0, dcoef, x, w):
    """`dwdx_plain` on the card: one launch of convstage_dwdx."""
    b, h, wd = _check((z0, dy0, x))
    ci, co = x.shape[3], z0.shape[3]
    if dy0.shape != z0.shape or x.shape[:3] != z0.shape[:3]:
        raise ValueError(f"shapes: z0 {tuple(z0.shape)} dy0 {tuple(dy0.shape)} "
                         f"x {tuple(x.shape)}")
    _weights_ok(w, ci, co, z0)
    _check_small(dcoef, (3, co), z0, "dcoef (c0, c1, c2)")
    dev = z0.device
    blocks = _max_blocks(dev)
    dx = torch.empty_like(x)
    dw_partial = torch.empty((blocks, 9, ci, co), dtype=torch.float32, device=dev)
    dw = torch.empty((9, ci, co), dtype=torch.float64, device=dev)
    _launch("dwdx", z0, z0.data_ptr(), dy0.data_ptr(), dcoef.data_ptr(), x.data_ptr(),
            w.data_ptr(), dx.data_ptr(), dw_partial.data_ptr(), dw.data_ptr(),
            b, h, wd, ci, co, blocks, _stream(z0))
    return dx, _hwio_to_dw(dw, ci, co)


_KERNEL_PASSES = {"conv": conv_kernel, "bnconv": bnconv_kernel, "bnpool": bnpool_kernel,
                  "poolsums": poolsums_kernel, "dz1": dz1_kernel, "dwprev": dwprev_kernel,
                  "dwdx": dwdx_kernel}
_PLAIN_PASSES = {"conv": conv_plain, "bnconv": bnconv_plain, "bnpool": bnpool_plain,
                 "poolsums": poolsums_plain, "dz1": dz1_plain, "dwprev": dwprev_plain,
                 "dwdx": dwdx_plain}


def passes_for(t: torch.Tensor, plain: Optional[bool] = None) -> Dict:
    """The seven passes for a tensor: the kernels on a CUDA tensor, the plain
    versions on a CPU tensor. `plain=True` forces the plain versions (the
    comparisons on the card use it; nothing on the main path does)."""
    if plain is None:
        plain = not t.is_cuda
    return _PLAIN_PASSES if plain else _KERNEL_PASSES


# ------------------------------------------------------------------ the stage
def stage_forward(x, w0, g0, b0, w1, g1, b1, external_first: bool,
                  plain: Optional[bool] = None):
    """Forward of one stage on channels-last x. Returns ((p, e, mean0, var0,
    mean1, var1), residuals for `stage_backward`)."""
    ps = passes_for(x, plain)
    if external_first:
        z0, sums0 = x, _sums(x)
    else:
        z0, sums0 = ps["conv"](x, w0)
    n = z0.shape[0] * z0.shape[1] * z0.shape[2]
    mean0, var0, coef0 = bn_fwd_coef(sums0, n, g0, b0)
    z1, sums1 = ps["bnconv"](z0, coef0, w1)
    mean1, var1, coef1 = bn_fwd_coef(sums1, n, g1, b1)
    e, p = ps["bnpool"](z1, coef1)
    res = (None if external_first else x, z0, z1, w0, w1, g0, g1,
           mean0, var0, coef0, mean1, var1, coef1)
    return (p, e, mean0, var0, mean1, var1), res


def stage_backward(res, dp, de, external_first: bool, plain: Optional[bool] = None):
    """Backward of one stage from `stage_forward`'s residuals and the
    cotangents of (p, e); either may be None. Returns (dx, dw0, dg0, db0,
    dw1, dg1, db1); with `external_first` dx is dz0 and dw0 is None."""
    x, z0, z1, w0, w1, g0, g1, mean0, var0, coef0, mean1, var1, coef1 = res
    ps = passes_for(z0, plain)
    n = z0.shape[0] * z0.shape[1] * z0.shape[2]
    sums_dy1 = ps["poolsums"](z1, coef1, dp, de)
    dcoef1, dg1, db1 = bn_bwd_coef(sums_dy1, n, mean1, var1, g1)
    dz1 = ps["dz1"](z1, coef1, dcoef1, dp, de)
    dy0, dw1, sums_dy0 = ps["dwprev"](dz1, z0, coef0, w1)
    dcoef0, dg0, db0 = bn_bwd_coef(sums_dy0, n, mean0, var0, g0)
    if external_first:
        # dz0 goes back to the ordinary first convolution, in z0's dtype
        dz0 = bn_bwd(dy0, z0, dcoef0).to(z0.dtype)
        return dz0, None, dg0, db0, dw1, dg1, db1
    dx, dw0 = ps["dwdx"](z0, dy0, dcoef0, x, w0)
    return dx, dw0, dg0, db0, dw1, dg1, db1


class FusedConvStage(torch.autograd.Function):
    """(p, e, mean0, var0, mean1, var1) of one stage on channels-last `x`
    [B, H, W, Ci] (or z0 [B, H, W, C] with `external_first`, where `w0` is
    None). Weights are [3, 3, Ci, Co]. Gradients flow through p and e only;
    the four batch statistics are not differentiable."""

    @staticmethod
    def forward(ctx, x, w0, g0, b0, w1, g1, b1, external_first: bool):
        det = [None if t is None else t.detach().contiguous()
               for t in (x, w0, g0, b0, w1, g1, b1)]
        out, res = stage_forward(*det, external_first)
        ctx.external_first = external_first
        ctx.none_slots = tuple(i for i, t in enumerate(res) if t is None)
        ctx.save_for_backward(*[t for t in res if t is not None])
        ctx.mark_non_differentiable(*out[2:])
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, dp, de, *_stats_cotangents):
        saved = list(ctx.saved_tensors)
        res = [None if i in ctx.none_slots else saved.pop(0) for i in range(13)]
        if dp is None and de is None:
            return (None,) * 8
        dp = None if dp is None else dp.contiguous()
        de = None if de is None else de.contiguous()
        dx, dw0, dg0, db0, dw1, dg1, db1 = stage_backward(res, dp, de, ctx.external_first)
        return dx, dw0, dg0, db0, dw1, dg1, db1, None


def fused_conv_stage(x, w0, g0, b0, w1, g1, b1, *, external_first: bool = False):
    """One train-mode ConvBlock + pool stage on channels-last `x`, float32 or
    bfloat16 (the compute dtype; weights and BN parameters stay float32).
    Returns (p, e, mean0, var0, mean1, var1): pooled output [B, H/2, W/2, C]
    and pre-pool activation e [B, H, W, C] in x's dtype, and the two BN batch
    statistics [C] in float32 (biased variances)."""
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16 [B, H, W, C], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"the stage pools 2x2: H and W must be even, got {tuple(x.shape)}")
    return FusedConvStage.apply(x, None if external_first else w0, g0, b0, w1, g1, b1,
                                bool(external_first))
