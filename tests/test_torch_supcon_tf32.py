"""The arithmetic of the supcon kernels, emulated on the CPU.

`spcl_torch/ops/csrc/supcon.cu` computes its two products on the tensor cores
in 3xTF32 (hi = x rounded to the nearest TF32 value, lo = x - hi read
truncated by the MMA; lo*hi + hi*lo + hi*hi accumulated in float32, in
short chains added on the CUDA cores, which a CPU sum in float32 stands for
here), the s product over the depth held in shared memory (D zero-padded to
256) in four quarters that are added in order, and it splits the column
sweep of each row tile over the S blocks of a cluster: block b sums its own
contiguous column tiles of 32, and the per-row partials (pass A, pass B) and
the partial dz are added in block-rank order. Here the same arithmetic runs
in torch on float32 tensors, and it is held

- against spcl_tpu's `_fwd_stats` / `_bwd_dz` (Pallas, interpret mode) and
  against the port's plain versions, at 2N = 60, 2N = 126 and a strip with
  rows != cols, in the three weighting modes, within the tolerances with
  which chip_smoke.py holds the kernels on the card: 2e-4 absolute on the
  per-row statistics (rowloss, c, log denom, a), 2e-4 x max|dz| on dz;
- for every split S of the column sweep, uneven ones included;
- and one TF32 pass (both operands rounded to TF32) is shown to miss the
  statistics' tolerance at 2N = 126: s carries 1/T = 14.3x the rounding of
  the dot product, which is why the kernels take three.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu.ops import supcon_pallas as jax_fused
from spcl_torch.ops import supcon_cuda as sc
from test_torch_convstage_tf32 import tf32_rna, tf32_trunc

D = 256
DP = 256          # depth the kernels hold in shared memory
KQ = 4            # depth quarters of the s product
TILE = 32         # columns of one column tile
INV_T = 1 / 0.07
STAT_TOL = 2e-4   # absolute, on rowloss, c, log denom and a
DZ_TOL = 2e-4     # x max|dz|


def split_rn(x):
    """(hi, lo) as supcon.cu's `split` makes them and the MMA reads them: hi
    = x rounded to the nearest TF32 value, lo = x - hi read truncated."""
    x = x.float()
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def _three(a, b):
    """a @ b in 3xTF32: lo*hi + hi*lo + hi*hi, each product in float32."""
    (ah, al), (bh, bl) = split_rn(a), split_rn(b)
    return al @ bh + ah @ bl + ah @ bh


def s_product(zr, zc):
    """zr @ zc.T as the kernels form it: depth padded to DP, four quarters of
    it in 3xTF32, added in order."""
    pad = DP - zr.shape[1]
    zr, zc = torch.nn.functional.pad(zr, (0, pad)), torch.nn.functional.pad(zc, (0, pad))
    q = DP // KQ
    out = torch.zeros(zr.shape[0], zc.shape[0])
    for k in range(KQ):
        out = out + _three(zr[:, k * q:(k + 1) * q], zc[:, k * q:(k + 1) * q].T)
    return out


def _blocks(cols, split):
    """The contiguous column ranges of the `split` blocks of a cluster."""
    tiles = cols // TILE
    return [slice(b * tiles // split * TILE, (b + 1) * tiles // split * TILE)
            for b in range(split)]


def _in_block_order(x, cols, split):
    """Per-row sums of x [rows, cols] over each block's columns, added in
    block-rank order."""
    out = torch.zeros(x.shape[0])
    for blk in _blocks(cols, split):
        out = out + x[:, blk].sum(dim=1)
    return out


def _weights(logp, gamma, mode):
    if mode == "none":
        return torch.ones_like(logp)
    if mode == "hard":
        return (-logp <= gamma).float()
    return torch.clamp(1.0 + logp * (1.0 / gamma), min=0.0)  # soft, by the reciprocal


def _pairs(s, lab_r, lab_c, val_r, val_c, gid_r, gid_c):
    a = (gid_c[None, :] != gid_r[:, None]).float() * val_c[None, :] * val_r[:, None]
    p = (lab_c[None, :] == lab_r[:, None]).float() * a
    e = torch.exp(torch.where(a > 0, s, torch.full_like(s, -1e30)))
    return p, e


def emulated_fwd(zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c, gamma, mode, split):
    """(denom, c, rawloss, spsum) per row, as supcon_fwd forms them."""
    s = s_product(zr, zc) * INV_T - INV_T
    p, e = _pairs(s, lab_r, lab_c, val_r, val_c, gid_r, gid_c)
    cols = zc.shape[0]
    denom, c = _in_block_order(e, cols, split), _in_block_order(p, cols, split)
    logp = s - torch.log(denom + 1e-16)[:, None]
    pw = p * _weights(logp, gamma, mode)
    return denom, c, _in_block_order(pw * logp, cols, split), _in_block_order(pw, cols, split)


def emulated_dz(zr, zc, lab_r, lab_c, val_r, val_c, gid_r, gid_c, c_r, c_c, den_r, den_c,
                a_r, a_c, gamma, scale, mode, split):
    """dz of the rows, as supcon_bwd forms it: G with the reciprocals of
    max(c, 1) and denom + eps, then G @ z_cols in 3xTF32 per block, the
    blocks' partials added in block-rank order."""
    s = s_product(zr, zc) * INV_T - INV_T
    p, e = _pairs(s, lab_r, lab_c, val_r, val_c, gid_r, gid_c)

    def g_side(c, den, a_stat, valid, b):
        m = (c > 0).float() * valid
        logp = s - b(torch.log(den + 1e-16))
        w = _weights(logp, gamma, mode)
        return -(b(m) * scale) * (p * w * b(1.0 / torch.clamp(c, min=1.0))
                                  - b(a_stat) * (e * b(1.0 / (den + 1e-16))))

    g = (g_side(c_r, den_r, a_r, val_r, lambda v: v[:, None])
         + g_side(c_c, den_c, a_c, val_c, lambda v: v[None, :])) * INV_T
    dz = torch.zeros(zr.shape)
    for blk in _blocks(zc.shape[0], split):
        dz = dz + _three(g[:, blk], zc[blk])
    return dz


# ------------------------------------------------------------------ operands
def _batch(n2, seed):
    """z [2N, D] L2-normalized around 3 label centres (as chip_smoke.py's
    `_inputs`), labels in 3 partitions, numpy-made."""
    rng = np.random.default_rng(seed)
    n = n2 // 2
    labels = np.arange(n) % 3
    centres = rng.standard_normal((3, D))
    z = np.concatenate([centres[labels], centres[labels]]) * 0.3 + rng.standard_normal((n2, D))
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    return (torch.from_numpy(z[:n].astype(np.float32)), torch.from_numpy(z[n:].astype(np.float32)),
            torch.from_numpy(labels.astype(np.int32)), torch.ones(n))


def _operands(shape, seed):
    """Row and column operands padded to 128 (the TPU kernels' row block):
    the square form at 2N = 60 or 126, or the strip of the first 128 rows of
    2N = 252 against all 256 columns."""
    n2 = {"2N=60": 60, "2N=126": 126, "strip 128x256": 252}[shape]
    z1, z2, labels, valid = _batch(n2, seed)
    valid[-2:] = 0.0  # an invalid tail beside the padding
    z, t2, v2, n_pad = sc._prepare(z1, z2, labels, valid, block=128)
    gid = torch.arange(n_pad, dtype=torch.float32)
    cols = (z, t2, v2, gid)
    rows = tuple(x[:128].contiguous() for x in cols) if shape.startswith("strip") else cols
    return rows, cols


def _hard_gamma(rows, cols):
    """A gamma inside the spread of the positive pairs' -logp, at the widest
    gap among their top 1% (away from ties, as chip_smoke.py picks it)."""
    (zr, tr, vr, gr), (zc, tc, vc, gc) = rows, cols
    s = (zr @ zc.T) * INV_T - INV_T
    p, e = _pairs(s, tr, tc, vr, vc, gr, gc)
    nll = -(s - torch.log(e.sum(1) + 1e-16)[:, None])
    vals = torch.sort(nll[p > 0]).values
    top = vals[min(int(0.99 * (len(vals) - 1)), len(vals) - 3):]
    k = int(torch.argmax(top[1:] - top[:-1]))
    return float((top[k] + top[k + 1]) / 2)


def _gamma(mode, rows, cols):
    return {"none": 1e9, "soft": 8.0, "hard": _hard_gamma(rows, cols)}[mode]


def _stats_err(got, want):
    """max abs error over rowloss, c, log denom and a (from denom, c,
    rawloss, spsum)."""
    def derived(x):
        denom, c, raw, sps = x
        c_safe = torch.clamp(c, min=1.0)
        return raw / c_safe, c, torch.log(denom + 1e-16), sps / c_safe
    return max(float((g - w).abs().max()) for g, w in zip(derived(got), derived(want)))


def _column_stats(cols, gamma, mode):
    """(c, denom, a) of the column entries: the plain forward of the columns
    against themselves."""
    (zc, tc, vc, gc) = cols
    denom, c, _, sps = sc.fwd_stats_plain(zc, zc, tc, tc, vc, vc, gc, gc, INV_T, gamma, mode)
    return c, denom, sps / torch.clamp(c, min=1.0)


def _jax(x):
    return jnp.asarray(x.numpy())


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("mode", ["none", "soft", "hard"])
@pytest.mark.parametrize("shape,split", [("2N=60", 2), ("2N=126", 3), ("strip 128x256", 5)])
def test_emulated_kernels_match_jax_and_plain(shape, split, mode):
    rows, cols = _operands(shape, seed=len(shape))
    gamma = _gamma(mode, rows, cols)
    ops = tuple(x for pair in zip(rows, cols) for x in pair)
    got = emulated_fwd(*ops, gamma, mode, split)
    plain = sc.fwd_stats_plain(*ops, INV_T, gamma, mode)
    rowloss, c, denom, a, spsum = (np.array(x)[:, 0] for x in jax_fused._fwd_stats(
        *(_jax(x) for x in ops), jnp.float32(INV_T), jnp.float32(gamma), mode))
    ref = tuple(torch.from_numpy(x) for x in (denom, c, rowloss * np.maximum(c, 1.0), spsum))
    assert _stats_err(got, plain) <= STAT_TOL
    assert _stats_err(got, ref) <= STAT_TOL
    assert torch.equal(got[1], plain[1])  # positive counts: exact

    c_c, den_c, a_c = _column_stats(cols, gamma, mode)
    n = rows[0].shape[0]
    c_r, den_r = got[1], got[0]
    a_r = got[3] / torch.clamp(got[1], min=1.0)
    stats = (c_r, c_c, den_r, den_c, a_r, a_c)
    scale = torch.tensor(1.0 / n)
    dz = emulated_dz(*ops, *stats, gamma, scale, mode, split)
    dz_plain = sc.bwd_dz_plain(*ops, *stats, INV_T, gamma, scale, mode)
    dz_jax = torch.from_numpy(np.array(jax_fused._bwd_dz(
        *(_jax(x) for x in ops + stats), jnp.float32(INV_T), jnp.float32(gamma),
        jnp.float32(1.0 / n), mode)))
    tol = DZ_TOL * float(dz_plain.abs().max())
    assert float((dz - dz_plain).abs().max()) <= tol
    assert float((dz - dz_jax).abs().max()) <= tol


@pytest.mark.parametrize("split", [1, 2, 3, 7, 8])
def test_every_column_split_holds_the_tolerance(split):
    """However the sweep is split over a cluster (8 column tiles here, so 3
    and 7 blocks own unequal shares and 8 one tile each), the sums in block
    order stay within float32 order of the plain version."""
    rows, cols = _operands("strip 128x256", seed=3)
    ops = tuple(x for pair in zip(rows, cols) for x in pair)
    got = emulated_fwd(*ops, 8.0, "soft", split)
    assert _stats_err(got, sc.fwd_stats_plain(*ops, INV_T, 8.0, "soft")) <= STAT_TOL / 20
    c_c, den_c, a_c = _column_stats(cols, 8.0, "soft")
    stats = (got[1], c_c, got[0], den_c, got[3] / torch.clamp(got[1], min=1.0), a_c)
    scale = torch.tensor(1 / 128)
    dz = emulated_dz(*ops, *stats, 8.0, scale, "soft", split)
    dz_plain = sc.bwd_dz_plain(*ops, *stats, INV_T, 8.0, scale, "soft")
    assert float((dz - dz_plain).abs().max()) <= DZ_TOL / 20 * float(dz_plain.abs().max())


def test_one_tf32_pass_misses_the_tolerance_at_126():
    """One TF32 pass, both operands rounded to TF32 as cvt.rna does: s then
    carries 1/T = 14.3x the rounding of a unit-vector dot product, and the
    per-row statistics miss the chip's 2e-4 (2.5e-4 on these inputs, against
    1e-6 for 3xTF32)."""
    rows, cols = _operands("2N=126", seed=5)
    ops = tuple(x for pair in zip(rows, cols) for x in pair)
    plain = sc.fwd_stats_plain(*ops, INV_T, 8.0, "soft")
    (zr, zc) = rows[0], cols[0]
    one = sc.fwd_stats_plain(tf32_rna(zr), tf32_rna(zc), *ops[2:], INV_T, 8.0, "soft")
    three = emulated_fwd(*ops, 8.0, "soft", 1)
    one_err, three_err = _stats_err(one, plain), _stats_err(three, plain)
    assert one_err > STAT_TOL
    assert three_err <= STAT_TOL / 20
