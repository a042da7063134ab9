"""spcl_torch's self-paced SupCon against spcl_tpu's, on the CPU.

The same numpy inputs (fixed seed) go through
- spcl_tpu.losses.supcon (dense jnp) and spcl_tpu.ops.supcon_pallas (the
  Pallas kernels, interpret mode off the TPU), and
- spcl_torch.losses.supcon (dense torch) and spcl_torch.ops.supcon_cuda,
  whose wrapper takes the plain per-row version for CPU tensors,
over the gamma grid {0.5, 3, 14, 80, 1e6}, hard and soft weights,
correct_grad on and off, padded rows and a size with several TPU column
blocks.

Tolerances: float32 throughout, sums in another order than XLA's — loss and
ratio rtol 1e-5 (atol 1e-6); dz rtol 1e-4, atol 1e-6; per-row statistics
rtol 1e-5, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu.losses.supcon import self_paced_supcon_loss as jax_sp_loss
from spcl_tpu.losses.supcon import supcon_loss as jax_supcon_loss
from spcl_tpu.ops import supcon_pallas as jax_fused
from spcl_torch.losses.supcon import self_paced_supcon_loss, supcon_loss
from spcl_torch.ops import supcon_cuda as sc

GAMMAS = (0.5, 3.0, 14.0, 80.0, 1e6)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
DZ_TOL = dict(rtol=1e-4, atol=1e-6)


def _inputs(n, d=32, seed=5, n_labels=3, pad=0):
    rng = np.random.RandomState(seed)
    z1 = rng.randn(n, d).astype(np.float32)
    z2 = (z1 + 0.8 * rng.randn(n, d)).astype(np.float32)
    z1 /= np.linalg.norm(z1, axis=1, keepdims=True)
    z2 /= np.linalg.norm(z2, axis=1, keepdims=True)
    labels = rng.randint(0, n_labels, size=n).astype(np.int32)
    valid = np.ones(n, np.float32)
    if pad:
        valid[-pad:] = 0.0
    return z1, z2, labels, valid


_JAX_FNS = {}


def _jax_fn(kind, mode, correct_grad):
    """jitted value-and-grad per (kind, mode, correct_grad); gamma is traced
    so the gamma grid reuses one compile."""
    key = (kind, mode, correct_grad)
    if key not in _JAX_FNS:
        fn = jax_sp_loss if kind == "dense" else jax_fused.fused_self_paced_supcon

        def run(a, b, t, v, g):
            def f(a_, b_):
                loss, aux = fn(a_, b_, gamma=g, target=t, valid=v, weight_update=mode,
                               correct_grad=correct_grad)
                return loss, (aux.downgrade_ratio if hasattr(aux, "downgrade_ratio") else aux)
            (loss, ratio), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(a, b)
            return loss, ratio, grads[0], grads[1]

        _JAX_FNS[key] = jax.jit(run)
    return _JAX_FNS[key]


def _jax(kind, z1, z2, labels, valid, gamma, mode, correct_grad):
    out = _jax_fn(kind, mode, correct_grad)(jnp.asarray(z1), jnp.asarray(z2),
                                            jnp.asarray(labels), jnp.asarray(valid),
                                            jnp.float32(gamma))
    return [np.asarray(x) for x in out]


def _torch(fn, z1, z2, labels, valid, gamma, mode, correct_grad):
    a = torch.tensor(z1, requires_grad=True)
    b = torch.tensor(z2, requires_grad=True)
    loss, aux = fn(a, b, gamma=gamma, target=torch.tensor(labels), valid=torch.tensor(valid),
                   weight_update=mode, correct_grad=correct_grad)
    ratio = aux.downgrade_ratio if hasattr(aux, "downgrade_ratio") else aux
    loss.backward()
    return [x.detach().numpy() for x in (loss, ratio, a.grad, b.grad)]


def _assert_same(port, ref):
    np.testing.assert_allclose(port[0], ref[0], **LOSS_TOL)
    np.testing.assert_allclose(port[1], ref[1], **LOSS_TOL)
    np.testing.assert_allclose(port[2], ref[2], **DZ_TOL)
    np.testing.assert_allclose(port[3], ref[3], **DZ_TOL)


@pytest.mark.parametrize("correct_grad", [False, True])
@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("gamma", GAMMAS)
def test_fused_matches_jax_dense_and_pallas(gamma, mode, correct_grad):
    """Port's fused wrapper (plain per-row path) == spcl_tpu's dense loss and
    its Pallas kernels (interpret mode): loss, ratio and dz, 2N=16."""
    z1, z2, labels, valid = _inputs(8)
    port = _torch(sc.fused_self_paced_supcon, z1, z2, labels, valid, gamma, mode, correct_grad)
    _assert_same(port, _jax("dense", z1, z2, labels, valid, gamma, mode, correct_grad))
    _assert_same(port, _jax("pallas", z1, z2, labels, valid, gamma, mode, correct_grad))


@pytest.mark.parametrize("correct_grad", [False, True])
@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("gamma", GAMMAS)
def test_dense_loss_matches_jax_dense(gamma, mode, correct_grad):
    """Port's dense torch loss (the use_fused=False path) == spcl_tpu's."""
    z1, z2, labels, valid = _inputs(8, seed=6)
    port = _torch(self_paced_supcon_loss, z1, z2, labels, valid, gamma, mode, correct_grad)
    _assert_same(port, _jax("dense", z1, z2, labels, valid, gamma, mode, correct_grad))


@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_padded_rows_match_jax(mode):
    """valid=0 rows drop out of the loss, the ratio and the gradients."""
    z1, z2, labels, valid = _inputs(8, seed=7, pad=3)
    port = _torch(sc.fused_self_paced_supcon, z1, z2, labels, valid, 3.0, mode, True)
    ref = _jax("pallas", z1, z2, labels, valid, 3.0, mode, True)
    _assert_same(port, ref)
    assert np.all(port[2][-3:] == 0) and np.all(port[3][-3:] == 0)


def test_several_column_blocks_match_jax_pallas():
    """2N=640: the TPU kernel runs a 5 x 5 grid of (128, 128) blocks; the
    port's tile is 32 rows. Loss, ratio and dz agree with padding."""
    z1, z2, labels, valid = _inputs(320, d=16, seed=8, pad=7)
    port = _torch(sc.fused_self_paced_supcon, z1, z2, labels, valid, 14.0, "hard", False)
    _assert_same(port, _jax("pallas", z1, z2, labels, valid, 14.0, "hard", False))


def test_fused_supcon_matches_jax():
    z1, z2, labels, valid = _inputs(8, seed=9)
    port = sc.fused_supcon(torch.tensor(z1), torch.tensor(z2), target=torch.tensor(labels))
    dense, _ = supcon_loss(torch.tensor(z1), torch.tensor(z2), target=torch.tensor(labels))
    ref = jax_fused.fused_supcon(jnp.asarray(z1), jnp.asarray(z2), target=jnp.asarray(labels))
    ref_dense, _ = jax_supcon_loss(jnp.asarray(z1), jnp.asarray(z2), target=jnp.asarray(labels))
    np.testing.assert_allclose(float(port), float(ref), **LOSS_TOL)
    np.testing.assert_allclose(float(dense), float(ref_dense), **LOSS_TOL)


@pytest.mark.parametrize("mode", ["none", "hard", "soft"])
@pytest.mark.parametrize("pad", [0, 3])
def test_plain_row_stats_match_jax_fwd_stats(mode, pad):
    """Per-row (rowloss, c, denom, a, spsum) of the port's plain version ==
    spcl_tpu's `_fwd_stats` (Pallas, interpret) on the same padded operands."""
    z1, z2, labels, valid = _inputs(8, seed=10, pad=pad)
    z, t2, v2, n_pad = sc._prepare(torch.tensor(z1), torch.tensor(z2), torch.tensor(labels),
                                   torch.tensor(valid), block=128)
    gid = torch.arange(n_pad, dtype=torch.float32)
    port = sc.fwd_stats(z, z, t2, t2, v2, v2, gid, gid, 1 / 0.07, 3.0, mode)
    jz, jt, jv, gj = (jnp.asarray(x.numpy()) for x in (z, t2, v2, gid))
    ref = jax_fused._fwd_stats(jz, jz, jt, jt, jv, jv, gj, gj, jnp.float32(1 / 0.07),
                               jnp.float32(3.0), mode)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r)[:, 0], rtol=1e-5, atol=1e-5)


def test_plain_dz_matches_jax_bwd_dz():
    """The port's plain dz == spcl_tpu's `_bwd_dz` (Pallas, interpret) on an
    independent rows x cols rectangle (the row-strip form)."""
    z1, z2, labels, valid = _inputs(64, seed=11, pad=2)
    z, t2, v2, n_pad = sc._prepare(torch.tensor(z1), torch.tensor(z2), torch.tensor(labels),
                                   torch.tensor(valid), block=128)
    gid = torch.arange(n_pad, dtype=torch.float32)
    _, c, denom, a, _ = sc.fwd_stats(z, z, t2, t2, v2, v2, gid, gid, 1 / 0.07, 8.0, "soft")
    rows = slice(0, 128)  # a strip: the first 128 rows against all columns
    scale = torch.tensor(0.01)
    port = sc.bwd_dz_plain(z[rows], z, t2[rows], t2, v2[rows], v2, gid[rows], gid,
                           c[rows], c, denom[rows], denom, a[rows], a, 1 / 0.07, 8.0,
                           scale, "soft")
    j = {k: jnp.asarray(v.numpy()) for k, v in dict(z=z, t=t2, v=v2, g=gid, c=c, d=denom,
                                                    a=a).items()}
    ref = jax_fused._bwd_dz(j["z"][rows], j["z"], j["t"][rows], j["t"], j["v"][rows], j["v"],
                            j["g"][rows], j["g"], j["c"][rows], j["c"], j["d"][rows], j["d"],
                            j["a"][rows], j["a"], jnp.float32(1 / 0.07), jnp.float32(8.0),
                            jnp.float32(0.01), "soft")
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **DZ_TOL)


def test_no_gradient_through_ratio_and_labels():
    z1, z2, labels, valid = _inputs(8, seed=12)
    a = torch.tensor(z1, requires_grad=True)
    loss, ratio = sc.fused_self_paced_supcon(a, torch.tensor(z2), gamma=3.0,
                                             target=torch.tensor(labels), weight_update="soft")
    assert not ratio.requires_grad
    assert loss.requires_grad
