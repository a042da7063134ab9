"""Shifted-window multi-head self-attention of the Swin Transformer block
(Liu et al., arXiv 2103.14030) on float32 tokens: the kernels of
`csrc/wattn.cu` behind a `torch.autograd.Function`, the plain PyTorch
version, and launch counts.

No TPU kernel is replaced: spcl_tpu has no transformer. The function, for
one block of `heads` heads over windows of ws x ws tokens, cyclically
shifted by `shift` (0 for an unshifted block):

    qkv           [B, H, W, 3C]  the qkv projection of the block's tokens, in
                                 the image's own (unshifted, unpartitioned)
                                 order, columns (q|k|v, head, d)
    windows       the tokens rolled by (-shift, -shift), cut into windows
    S             (q * scale) k^T + table[index] (+ mask)  per window and head
    out           softmax(S) v, put back where each token came from
                  [B, H, W, C], columns (head, d)

`index` is the published relative index, (dh + ws - 1)(2 ws - 1) + (dw +
ws - 1) of the query's and key's offsets inside the window, `table`
[(2 ws - 1)^2, heads] the learned bias, and `mask` -100 between tokens of
different regions of the published 3 x 3 labelling of the shifted image
(`shift_mask`). The roll and the partition are permutations of tokens, and
the layers around the attention act token by token, so the block computes
the qkv projection and the output projection in the image's order, and the
kernels fold the roll and the partition into their addressing: a window's
token (i, j) at shifted position (y, x) reads and writes the token at ((y +
shift) mod H, (x + shift) mod W). No rolled or partitioned copy is made.

  kernel in csrc/wattn.cu   one block per (window, head)  reads, writes
  `wattn_fwd`               S, softmax, P v               qkv -> out
  `wattn_bwd`               P again; dv = P^T dO; dP = dO v^T; dS = P (dP -
                            rowsum(dP P)); dq = scale dS k; dk = dS^T (q scale);
                            the window's sum of dS over each table entry
                                                          qkv, dout -> dqkv, partial sums
  `wattn_dbias`             the partial sums over the windows, in a fixed
                            order, float64               partial sums -> dtable

The bias gradient is a sum over every window; the windows' sums go to a
buffer and `wattn_dbias` adds them in window order, so that no float atomic
makes the result depend on the blocks' order, and a graphed step is
bit-equal to an eager one. Products and sums are float32 FMAs on the CUDA
cores (no tensor cores), accumulated in a fixed order; exp is `expf`.

Dispatch: `window_attention` runs the kernels on every CUDA input; they take
float32 with ws = 7, head size 32 and H, W multiples of 7 (the Swin-T
shapes), and any other CUDA input raises a ValueError that names what they
refuse (`refusal`), so a model on the card never trains without them. On
any other device it runs the plain version, and autograd gives its
backward. The
kernels are built with nvcc at their first launch into `build/spcl_torch/`
(`_build.py`), so only a process that runs a Swin model builds them.
`LAUNCHES` counts each kernel launch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from . import _build
from ..utils.profiling import launch_counts

SOURCE = _build.CSRC_DIR / "wattn.cu"

KERNELS = ("wattn_fwd", "wattn_bwd", "wattn_dbias")
# kernel name -> launches since the last reset
LAUNCHES: Dict[str, int] = launch_counts(KERNELS)

WINDOW = 7          # the kernels' window side (49 tokens)
HEAD_DIM = 32       # the kernels' head size
MASK_VALUE = -100.0  # the published value between regions

_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------------ build / bind
def build(verbose: bool = False) -> Tuple[Path, float, str]:
    """Compile `csrc/wattn.cu` with nvcc for sm_90a unless already built.
    Returns (library path, seconds spent compiling, compiler output)."""
    return _build.build_library(SOURCE, "spcl_wattn", verbose)


def bind(path: Path) -> ctypes.CDLL:
    """Load a library built from `csrc/wattn.cu` and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wattn_fwd.argtypes = [p, p, p, i, i, i, i, i, i, f, p]
    lib.wattn_bwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, p]
    lib.wattn_dbias.argtypes = [p, p, i, i, p]
    for name in KERNELS:
        getattr(lib, name).restype = i
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(build()[0])
    return _lib


# ------------------------------------------------------------------ index and mask
def relative_index(ws: int) -> torch.Tensor:
    """[ws^2, ws^2] int64: (dh + ws - 1)(2 ws - 1) + (dw + ws - 1), d = the
    query's window coordinates minus the key's (row-major tokens)."""
    c = torch.arange(ws)
    yy, xx = torch.meshgrid(c, c, indexing="ij")
    y, x = yy.reshape(-1), xx.reshape(-1)
    return (y[:, None] - y[None, :] + ws - 1) * (2 * ws - 1) + (x[:, None] - x[None, :] + ws - 1)


def region(p: torch.Tensor, size: int, ws: int, shift: int) -> torch.Tensor:
    """The published region label (0, 1, 2) of shifted coordinate p along an
    axis of `size`: [0, size - ws), [size - ws, size - shift), [size - shift,
    size). The kernels compute it so."""
    return (p >= size - ws).long() + (p >= size - shift).long()


def shift_mask(h: int, w: int, ws: int, shift: int) -> Optional[torch.Tensor]:
    """[nW, ws^2, ws^2] float32, 0 within a region and -100 across, of the
    windows of an h x w image rolled by (-shift, -shift) (windows in row-major
    order); None where shift is 0."""
    if not shift:
        return None
    lab = region(torch.arange(h), h, ws, shift)[:, None] * 3 \
        + region(torch.arange(w), w, ws, shift)[None, :]
    lab = lab.view(h // ws, ws, w // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    return torch.where(lab[:, :, None] == lab[:, None, :], 0.0, MASK_VALUE).float()


# ------------------------------------------------------------------ plain version
def _windows(t: torch.Tensor, ws: int, shift: int) -> torch.Tensor:
    """[B, H, W, c] -> [B nW, ws^2, c]: rolled by (-shift, -shift), cut into
    windows in row-major order."""
    if shift:
        t = torch.roll(t, (-shift, -shift), (1, 2))
    b, h, w, c = t.shape
    return t.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(-1, ws * ws, c)


def _unwindows(t: torch.Tensor, b: int, h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    """The inverse of `_windows`."""
    c = t.shape[-1]
    t = t.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
    return torch.roll(t, (shift, shift), (1, 2)) if shift else t


def _probs(qkv, table, index, mask, heads: int, ws: int, shift: int, scale: float):
    """(q * scale, k, v) [B nW, heads, ws^2, d] and softmax(S)."""
    b, h, w, c3 = qkv.shape
    n = ws * ws
    win = _windows(qkv, ws, shift).reshape(-1, n, 3, heads, c3 // 3 // heads)
    q, k, v = win.permute(2, 0, 3, 1, 4).unbind(0)
    q = q * scale
    s = q @ k.transpose(-2, -1) + table[index.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(-1, nw, heads, n, n) + mask[None, :, None]).reshape(-1, heads, n, n)
    return q, k, v, torch.softmax(s, dim=-1)


def fwd_plain(qkv, table, index, mask, heads: int, ws: int, shift: int,
              scale: float) -> torch.Tensor:
    """out [B, H, W, C] of the published computation: roll, partition,
    materialised ws^2 x ws^2 logits, softmax, P v, reverse, roll back."""
    b, h, w, c3 = qkv.shape
    _, _, v, p = _probs(qkv, table, index, mask, heads, ws, shift, scale)
    o = (p @ v).transpose(1, 2).reshape(-1, ws * ws, c3 // 3)
    return _unwindows(o, b, h, w, ws, shift)


# ------------------------------------------------------------------ kernels
def refusal(qkv: torch.Tensor, table: torch.Tensor, heads: int, ws: int,
            shift: int) -> Optional[str]:
    """Why the kernels cannot take this input, or None where they can: they
    take float32, contiguous, 16-byte aligned qkv [B, H, W, 3 heads 32] and
    table [169, heads] on one device, ws = 7 and H, W multiples of 7 (the
    Swin-T shapes)."""
    if qkv.dtype != torch.float32 or table.dtype != torch.float32:
        return f"qkv {qkv.dtype} and table {table.dtype}: the kernels take float32"
    if qkv.dim() != 4 or not qkv.is_contiguous() or not table.is_contiguous():
        return (f"qkv {tuple(qkv.shape)} strides {qkv.stride()}: the kernels take a "
                "contiguous [B, H, W, 3C] qkv and a contiguous table")
    if table.device != qkv.device:
        return f"qkv on {qkv.device}, table on {table.device}"
    b, h, w, c3 = qkv.shape
    if ws != WINDOW or c3 != 3 * heads * HEAD_DIM:
        return (f"window {ws}, {heads} heads of {c3 // 3 // max(heads, 1)}: the kernels "
                f"take windows of {WINDOW} and heads of {HEAD_DIM}")
    if h % ws or w % ws or not 0 <= shift < ws:
        return f"{h} x {w} tokens shifted by {shift}: not whole windows of {ws}"
    if table.shape != ((2 * ws - 1) ** 2, heads):
        return f"table {tuple(table.shape)}, not [{(2 * ws - 1) ** 2}, {heads}]"
    if qkv.data_ptr() % 16:
        return "qkv is not 16-byte aligned"
    if b * (h // ws) * (w // ws) >= 2 ** 31:
        return f"{b * (h // ws) * (w // ws)} windows: more than a grid holds"
    return None


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def fwd_kernel(qkv, table, heads: int, shift: int, scale: float) -> torch.Tensor:
    """`fwd_plain` on the card: one launch of wattn_fwd."""
    b, h, w, c3 = qkv.shape
    out = torch.empty((b, h, w, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    err = _load().wattn_fwd(qkv.data_ptr(), table.data_ptr(), out.data_ptr(), b, h, w,
                            c3 // 3, heads, shift, scale, _stream(qkv))
    _build.raise_on(err, "wattn_fwd")
    LAUNCHES["wattn_fwd"] += 1
    return out


def bwd_kernel(qkv, dout, table, heads: int, shift: int,
               scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dqkv, dtable), the gradient of `fwd_plain`, on the card: wattn_bwd,
    then wattn_dbias."""
    b, h, w, c3 = qkv.shape
    windows = b * (h // WINDOW) * (w // WINDOW)
    bins = table.shape[0]
    dqkv = torch.empty_like(qkv)
    part = torch.empty((heads * bins, windows), dtype=torch.float32, device=qkv.device)
    dtable = torch.empty_like(table)
    lib, stream = _load(), _stream(qkv)
    err = lib.wattn_bwd(qkv.data_ptr(), dout.data_ptr(), table.data_ptr(), dqkv.data_ptr(),
                        part.data_ptr(), b, h, w, c3 // 3, heads, shift, scale, stream)
    _build.raise_on(err, "wattn_bwd")
    LAUNCHES["wattn_bwd"] += 1
    err = lib.wattn_dbias(part.data_ptr(), dtable.data_ptr(), heads * bins, windows, stream)
    _build.raise_on(err, "wattn_dbias")
    LAUNCHES["wattn_dbias"] += 1
    return dqkv, dtable


# ------------------------------------------------------------------ dispatch
class WindowAttention(torch.autograd.Function):
    """The kernels' out = the block's window attention of `qkv` (see the
    module's docstring); the backward gives dqkv and the bias table's
    gradient."""

    @staticmethod
    def forward(ctx, qkv, table, heads: int, shift: int, scale: float):
        ctx.save_for_backward(qkv, table)
        ctx.args = (heads, shift, scale)
        return fwd_kernel(qkv, table, heads, shift, scale)

    @staticmethod
    def backward(ctx, dout):
        qkv, table = ctx.saved_tensors
        dqkv, dtable = bwd_kernel(qkv, dout.contiguous(), table, *ctx.args)
        return dqkv, dtable, None, None, None


def window_attention(qkv: torch.Tensor, table: torch.Tensor, index: torch.Tensor,
                     mask: Optional[torch.Tensor], *, heads: int, ws: int, shift: int,
                     scale: float) -> torch.Tensor:
    """out [B, H, W, C] of qkv [B, H, W, 3C] (image order): the kernels on a
    CUDA input, which raise a ValueError naming what they refuse; the plain
    version, differentiated by autograd, on any other device. `index` and
    `mask` (`relative_index`, `shift_mask`) serve the plain version; the
    kernels compute both from the tokens' coordinates."""
    if not qkv.is_cuda:
        return fwd_plain(qkv, table, index, mask, heads, ws, shift, scale)
    why = refusal(qkv, table, heads, ws, shift)
    if why is not None:
        raise ValueError(f"the window-attention kernels (csrc/wattn.cu) refuse this input: "
                         f"{why}")
    return WindowAttention.apply(qkv, table, int(heads), int(shift), float(scale))
