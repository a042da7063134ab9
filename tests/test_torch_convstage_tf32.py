"""The 3xTF32 arithmetic of the stage convolution kernels, emulated on the CPU.

`spcl_torch/ops/csrc/convstage.cu` computes its convolutions (the passes
`conv`, `bnconv`, `dwprev`, `dwdx`) on the tensor cores in 3xTF32: each
operand x is split into hi = x with its low 13 mantissa bits cleared (a TF32
value) and lo = x - hi (exact), the MMA reads the top 11 significant bits of
lo (truncation), and each product is accumulated as lo*hi + hi*lo + hi*hi in
float32. Here the same split is made in torch on float32 tensors and the
three products are three float32 convolutions, in place of the one
convolution of each plain pass. That checks the numerics choice without a
card:

- each emulated pass against its float32 plain version, within the chip's
  stage tolerance, STAGE_TOL = 2e-4 x max|plain| of each tensor, at B=2,
  8x16, 16->16 and 16->32;
- the whole stage, with the emulated passes behind `fused_conv_stage`,
  against spcl_tpu's `fused_packed_block` in interpret mode at the
  tolerances of `test_stage_matches_fused_packed_block`;
- activations spanning 1e-3..1e3: one TF32 pass (both operands rounded to
  TF32 as cvt.rna does) misses STAGE_TOL against a float64 reference, and
  3xTF32 holds it.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spcl_torch.ops import convstage_cuda as cs
from test_torch_convstage import check_stage_against_fused_packed_block

STAGE_TOL = 2e-4  # x max|plain|, as chip_smoke.py holds the kernels on the card


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor cores read: the low 13 mantissa bits dropped."""
    return (_bits(x) & ~0x1FFF).view(torch.float32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32)."""
    return ((_bits(x) + 0x1000) & ~0x1FFF).view(torch.float32)


def split3(x: torch.Tensor):
    """(hi, lo) as the kernels' `split` makes them and the MMA reads them."""
    x = x.float()
    hi = tf32_trunc(x)
    return hi, tf32_trunc(x - hi)


def _three(f, a, b):
    """f(a, b) bilinear, in 3xTF32: lo*hi + hi*lo + hi*hi."""
    (ah, al), (bh, bl) = split3(a), split3(b)
    return f(al, bh) + f(ah, bl) + f(ah, bh)


def _conv(a, w):
    return cs._nhwc(F.conv2d(cs._nchw(a), cs._oihw(w), padding=1))


def _conv_grads(a, w, g):
    d_in = _three(lambda w_, g_: torch.nn.grad.conv2d_input(
        cs._nchw(a).shape, cs._oihw(w_), cs._nchw(g_), padding=1), w, g)
    dw = _three(lambda a_, g_: torch.nn.grad.conv2d_weight(
        cs._nchw(a_), cs._oihw(w).shape, cs._nchw(g_), padding=1), a, g)
    return cs._nhwc(d_in), dw.permute(2, 3, 1, 0).contiguous()


# ---- the plain passes with their convolutions in emulated 3xTF32
def conv_3x(x, w):
    z = _three(_conv, x, w)
    return z, cs._sums(z)


def bnconv_3x(z0, coef, w):
    return conv_3x(torch.relu(cs._bn(z0, coef)), w)


def dwprev_3x(dz1, z0, coef, w):
    y0 = cs._bn(z0, coef)
    da0, dw = _conv_grads(torch.relu(y0), w, dz1)
    dy0 = torch.where(y0 >= 0, da0, torch.zeros_like(da0))
    return dy0, dw, cs._sums(dy0, z0)


def dwdx_3x(z0, dy0, dcoef, x, w):
    dz0 = dcoef[0] * dy0 + dcoef[1] + dcoef[2] * z0
    return _conv_grads(x, w, dz0)


EMULATED = {"conv": conv_3x, "bnconv": bnconv_3x, "dwprev": dwprev_3x, "dwdx": dwdx_3x}


def _pass_inputs(name, c_in, c, seed, b=2, h=8, w=16):
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    coef = torch.stack([1 + rn(c, scale=0.3), rn(c, scale=0.3)])
    if name == "conv":
        return rn(b, h, w, c_in), rn(3, 3, c_in, c, scale=(9 * c_in) ** -0.5)
    if name == "bnconv":
        return rn(b, h, w, c), coef, rn(3, 3, c, c, scale=(9 * c) ** -0.5)
    if name == "dwprev":
        return rn(b, h, w, c), rn(b, h, w, c), coef, rn(3, 3, c, c, scale=(9 * c) ** -0.5)
    dcoef = torch.stack([1 + rn(c, scale=0.3), rn(c, scale=0.1), rn(c, scale=0.1)])
    return (rn(b, h, w, c), rn(b, h, w, c), dcoef, rn(b, h, w, c_in),
            rn(3, 3, c_in, c, scale=(9 * c_in) ** -0.5))


def _worst(got, want):
    """max over tensors of |got - want| / max|want|."""
    return max(float((g.double() - p.double()).abs().max()) / max(float(p.abs().max()), 1e-12)
               for g, p in zip(got, want))


@pytest.mark.parametrize("name", ["conv", "bnconv", "dwprev", "dwdx"])
@pytest.mark.parametrize("c_in,c", [(16, 16), (16, 32)], ids=["same16", "expand16to32"])
def test_emulated_pass_holds_stage_tolerance(name, c_in, c):
    inputs = _pass_inputs(name, c_in, c, seed=c_in + c)
    got, want = EMULATED[name](*inputs), cs._PLAIN_PASSES[name](*inputs)
    assert len(got) == len(want)
    # float32 order: far inside the tolerance, not merely under it
    assert _worst(got, want) <= STAGE_TOL / 20


@pytest.mark.parametrize("external_first", [True, False])
@pytest.mark.parametrize("c_in,c_out", [(16, 16), (16, 32)], ids=["same16", "expand16to32"])
def test_emulated_stage_matches_fused_packed_block(monkeypatch, external_first, c_in, c_out):
    for name, fn in EMULATED.items():
        monkeypatch.setitem(cs._PLAIN_PASSES, name, fn)
    check_stage_against_fused_packed_block(external_first, c_in, c_out)


def _wide(rng, *shape):
    """float32 values of magnitude 1e-3..1e3 (log-uniform), random sign."""
    mag = 10.0 ** rng.uniform(-3.0, 3.0, shape)
    return torch.from_numpy((mag * rng.choice([-1.0, 1.0], shape)).astype(np.float32))


@pytest.mark.parametrize("name", ["conv", "dwdx"])
def test_wide_range_needs_three_passes(name):
    """Activations over six decades: one TF32 pass leaves more than STAGE_TOL
    of max|z| against float64; 3xTF32 stays at the float32 order."""
    rng = np.random.default_rng(4)
    x = _wide(rng, 2, 8, 16, 16)
    w = torch.from_numpy((rng.standard_normal((3, 3, 16, 32)) / 12.0).astype(np.float32))
    if name == "conv":
        want = _conv(x.double(), w.double())
        three = _three(_conv, x, w)
        one = _conv(tf32_rna(x), tf32_rna(w))
    else:  # the weight gradient of the same convolution under a wide-range dz
        g = _wide(rng, 2, 8, 16, 32)
        f = lambda a, g_: torch.nn.grad.conv2d_weight(  # noqa: E731
            cs._nchw(a), cs._oihw(w).shape, cs._nchw(g_), padding=1)
        want = f(x.double(), g.double())
        three = _three(f, x, g)
        one = f(tf32_rna(x), tf32_rna(g))
    assert _worst([three], [want]) <= STAGE_TOL / 20
    assert _worst([one], [want]) > STAGE_TOL


def test_split_is_exact_and_tf32():
    """hi is a TF32 value, x - hi is exact and below 2^-10 |x|, and what the
    MMA drops of lo is below 2^-21 |x|."""
    x = _wide(np.random.default_rng(5), 4096)
    hi, lo = split3(x)
    assert torch.equal(tf32_trunc(hi), hi) and torch.equal(tf32_trunc(lo), lo)
    rest = x - hi
    assert torch.equal(hi + rest, x)  # exact in float32
    assert bool((rest.abs() < x.abs() * 2.0 ** -10).all())
    assert bool(((rest - lo).abs() < x.abs() * 2.0 ** -21).all())
