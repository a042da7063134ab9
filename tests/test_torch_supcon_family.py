"""The soft-weighted SupCon family of spcl_torch (`losses/supcon.py`)
against spcl_tpu's (`losses/supcon.py:204-326`), on the CPU: the same
L2-normalised z of two views, labels, padding and weights go through both.

- `supcon_loss_in_mode` (SupConLoss2 "in" mode) by labels, by an explicit
  mask, with and without a padded slice;
- `soft_supcon_loss` (SupConLoss3) in "out" and "in" mode, with an enable
  mask and with padding;
- `assemble_block_weights` and `block_soft_supcon_loss` (SupConLoss4) with
  every combination of the three blocks.

Losses rtol 1e-5 and their gradients with respect to z relative L2 1e-4
(float32 [2N, 2N] products of 256-deep rows summed in another order); the
assembled weights and masks equal.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu.losses import supcon as jsup
from spcl_torch import losses
from spcl_torch.losses import supcon as psup

N, D = 6, 256


def _data(seed, pad):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(2 * N, D)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    labels = (np.arange(N) % 3).astype(np.int32)
    valid = np.ones(N, np.float32)
    if pad:
        valid[-1] = 0.0
    weights = rng.random((N, N)).astype(np.float32)
    return z[:N], z[N:], labels, valid, weights


def _both(jfn, pfn, z1, z2, **kw):
    """(jax loss, jax dz, port loss, port dz) of fn(z1, z2, **kw)."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    jl, jg = jax.value_and_grad(lambda a, b: jfn(a, b, **jkw), argnums=(0, 1))(
        jnp.asarray(z1), jnp.asarray(z2))
    a = torch.from_numpy(z1).requires_grad_(True)
    b = torch.from_numpy(z2).requires_grad_(True)
    pkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    pl = pfn(a, b, **pkw)
    pl.backward()
    jdz = np.concatenate([np.asarray(jg[0]), np.asarray(jg[1])])
    return float(jl), jdz, float(pl.detach()), torch.cat([a.grad, b.grad]).numpy()


def _check(jfn, pfn, z1, z2, **kw):
    jl, jdz, pl, pdz = _both(jfn, pfn, z1, z2, **kw)
    assert np.isfinite(pl)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert np.linalg.norm(pdz - jdz) <= 1e-4 * np.linalg.norm(jdz)


def test_exported_as_spcl_tpu_exports_them():
    for name in ("supcon_loss_in_mode", "soft_supcon_loss", "assemble_block_weights",
                 "block_soft_supcon_loss"):
        assert getattr(losses, name) is getattr(psup, name)
        assert name in losses.__all__


@pytest.mark.parametrize("pad", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("by", ["target", "pos_mask", "simclr"])
def test_supcon_loss_in_mode_matches_spcl_tpu(by, pad):
    z1, z2, labels, valid, _ = _data(1, pad)
    kw = {"valid": valid, "temperature": 0.1}
    if by == "target":
        kw["target"] = labels
    elif by == "pos_mask":
        kw["pos_mask"] = (labels[:, None] == labels[None, :]).astype(np.float32)
    _check(jsup.supcon_loss_in_mode, psup.supcon_loss_in_mode, z1, z2, **kw)


@pytest.mark.parametrize("pad", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("enable", [False, True], ids=["all", "enable_mask"])
@pytest.mark.parametrize("out_mode", [True, False], ids=["out", "in"])
def test_soft_supcon_loss_matches_spcl_tpu(out_mode, enable, pad):
    z1, z2, _, valid, weights = _data(2, pad)
    kw = {"pos_weight": weights, "temperature": 0.07, "out_mode": out_mode,
          "valid": valid if pad else None}
    if enable:
        kw["enable_mask"] = (np.random.default_rng(3).random((2 * N, 2 * N)) > 0.3
                             ).astype(np.float32)
    _check(jsup.soft_supcon_loss, psup.soft_supcon_loss, z1, z2, **kw)


BLOCKS = [c for r in (1, 2, 3) for c in itertools.combinations(
    ("one2one", "two2two", "one2two"), r)]


@pytest.mark.parametrize("blocks", BLOCKS, ids=["+".join(b) for b in BLOCKS])
def test_assemble_block_weights_matches_spcl_tpu(blocks):
    rng = np.random.default_rng(4)
    kw = {b: rng.random((N, N)).astype(np.float32) for b in blocks}
    jw, je = jsup.assemble_block_weights(N, **{k: jnp.asarray(v) for k, v in kw.items()})
    pw, pe = psup.assemble_block_weights(N, **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))


@pytest.mark.parametrize("pad", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("out_mode", [True, False], ids=["out", "in"])
@pytest.mark.parametrize("blocks", BLOCKS, ids=["+".join(b) for b in BLOCKS])
def test_block_soft_supcon_loss_matches_spcl_tpu(blocks, out_mode, pad):
    z1, z2, _, valid, _ = _data(5, pad)
    rng = np.random.default_rng(6)
    kw = {f"{b}_weight": rng.random((N, N)).astype(np.float32) for b in blocks}
    kw.update(temperature=0.07, out_mode=out_mode, valid=valid if pad else None)
    _check(jsup.block_soft_supcon_loss, psup.block_soft_supcon_loss, z1, z2, **kw)
