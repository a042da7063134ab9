"""The bf16 stage's BatchNorm + ReLU at its edges, on the CPU: where y0 =
z0*inv + shift is +0, -0.0, a tiny negative or halfway between two bf16
values (tests/torch_bf16_edges.py, numpy from a seed), the port's plain bf16
versions (`bnconv_plain`, `dwprev_plain`), which the bf16 kernels are held to
on the card, against spcl_tpu's `_k_bnconv` / `_k_dwprev` path.

- Elementwise, on `pass_inputs`: the convolution operand a0 = bf16(relu(y0))
  of the plain versions equals spcl_tpu's (`_a_rows`: `_bn`, max with 0,
  `astype(bfloat16)`) value for value, ties to even included, and so does the
  ReLU mask [y0 >= 0], except on the edges in FLUSHED, whose y0 is a float32
  subnormal: XLA:CPU flushes it to 0 (as the TPU does), so spcl_tpu's mask
  passes there and the port's, like the card's, does not (ROADMAP C9).
- The whole bf16 stage through `fused_packed_block` in interpret mode, at
  2 x 8 x 16 x 16 (`external_first`), with the edges' y0 set as BatchNorm
  sets it: gamma0 = 0 makes inv0 = 0 and shift0 = beta0 = the edge's y0.
  Every output and gradient within `STAGE_TOL` = 2e-3 relative L2 (the
  bound of tests/test_torch_bf16.py: the same roundings, sums in another
  order; measured up to 2.0e-4, on p); the sums of dy0 of a masked edge
  channel (dbeta0, dgamma0) are 0 in both, those of the passed edges
  within STAGE_TOL of spcl_tpu's (measured up to 8.0e-5).
- The BatchNorm backward at bf16 ties (`bn_bwd_ties`), float32 and bf16:
  the plain dz1 and dwdx's dz0 (read through dW0 at a one-hot x) equal
  spcl_tpu's `_k_dz1` and `dz_rows` formulas, evaluated in eager jnp (one
  rounding per operation), bit for bit; the fused order the kernels took
  before (c0*dy + (c2*z + c1), two FMAs) gives other bf16 values at about
  half the elements, so these inputs tell the two orders apart.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu.experimental.packed_block_pallas import _bn, fused_packed_block
from spcl_tpu.experimental.packed_stage import pack, unpack
from spcl_torch.ops import convstage_cuda as cs
from torch_bf16_edges import EDGES, FLUSHED, bn_bwd_ties, fused_order, pass_inputs, role, to_bf16

STAGE_TOL = 2e-3
# XLA:CPU keeps float32 between fused bf16 operations unless told not to
ROUND_EVERY_OP = {"xla_allow_excess_precision": False}
NAMES = ("x", "w0", "g0", "b0", "w1", "g1", "b1")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread (see tests/test_torch_semi_step.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_edge_operand_and_mask_match_spcl_tpu():
    z0, coef, _, _ = pass_inputs(2, 6, 10, 32, seed=5)
    y0_t = cs._bn(torch.from_numpy(z0).to(torch.bfloat16), torch.from_numpy(coef))
    a0_t = torch.relu(y0_t).to(torch.bfloat16).float().numpy()
    # eager: one rounding per operation, as in the kernel body
    y0_j = _bn(jnp.asarray(z0).astype(jnp.bfloat16), coef[0], coef[1])
    a0_j = np.asarray(jnp.maximum(y0_j, 0.0).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(a0_t, a0_j)
    mask_t, mask_j = (y0_t >= 0).numpy(), np.asarray(y0_j >= 0)
    for k in range(z0.shape[3]):
        edge = role(k)
        if edge is not None and edge[0] in FLUSHED:
            hit = z0[..., k] == edge[3]
            assert not mask_t[..., k][hit].any() and mask_j[..., k][hit].all(), edge[0]
            np.testing.assert_array_equal(mask_t[..., k][~hit], mask_j[..., k][~hit])
        else:
            np.testing.assert_array_equal(mask_t[..., k], mask_j[..., k])
    # the edges land where they should: ties to even, +0 and -0.0 pass, negatives masked
    for k, edge in ((k, role(k)) for k in range(len(EDGES))):
        hit = z0[..., k] == edge[3]
        assert hit.any()
        a0 = to_bf16(np.float32([max(edge[4], 0.0)]))[0]
        np.testing.assert_array_equal(a0_t[..., k][hit], a0)
        assert mask_t[..., k][hit].all() == (edge[4] >= 0), edge[0]


def _edge_stage_arrays(seed=11, b=2, h=8, w=16, c=16):
    """The bf16 stage's inputs with the edges' y0 in BatchNorm 0: gamma0 = 0
    and beta0 = y0 for each edge spcl_tpu does not flush."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    a = dict(x=to_bf16(rng.randn(b, h, w, c).astype(f32)),
             w0=(rng.randn(3, 3, c, c) * 0.2).astype(f32),
             w1=(rng.randn(3, 3, c, c) * 0.2).astype(f32),
             g0=(1.0 + 0.1 * rng.randn(c)).astype(f32), b0=(0.1 * rng.randn(c)).astype(f32),
             g1=(1.0 + 0.1 * rng.randn(c)).astype(f32), b1=(0.1 * rng.randn(c)).astype(f32),
             cp=rng.randn(b, h // 2, w // 2, c).astype(f32),
             ce=rng.randn(b, h, w, c).astype(f32))
    edges = {}
    for k in range(c):
        edge = role(k)
        if edge is not None and edge[0] not in FLUSHED:
            a["g0"][k], a["b0"][k] = 0.0, edge[4]
            edges[k] = edge
    return a, edges


def _jax_stage(a):
    """spcl_tpu's bf16 `fused_packed_block` (interpret mode, every bf16
    operation rounded): outputs and the gradients of sum(p*cp) + sum(e*ce)."""
    c = a["x"].shape[3]
    xpad = jnp.pad(pack(jnp.asarray(a["x"]).astype(jnp.bfloat16)),
                   ((0, 0), (1, 1), (1, 1), (0, 0)))
    jargs = (xpad,) + tuple(jnp.asarray(a[k]) for k in NAMES[1:])

    def loss(*args):
        out = fused_packed_block(*args, c, c, "bfloat16", True)
        p, e = (unpack(o, c).astype(jnp.float32) for o in out[:2])
        return jnp.sum(p * a["cp"]) + jnp.sum(e * a["ce"]), (p, e) + tuple(out[2:])

    fn = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(7)), has_aux=True))
    (_, out), grads = fn.lower(*jargs).compile(compiler_options=ROUND_EVERY_OP)(*jargs)
    g = dict(zip(NAMES, (np.asarray(v, np.float32) for v in grads)))
    g["x"] = np.asarray(unpack(grads[0][:, 1:-1, 1:-1, :].astype(jnp.float32), c))
    return [np.asarray(o, np.float32) for o in out], g


def test_bf16_stage_at_the_edges_matches_fused_packed_block():
    a, edges = _edge_stage_arrays()
    want, want_g = _jax_stage(a)
    targs = {k: torch.from_numpy(a[k].copy()).requires_grad_(True) for k in NAMES[1:]}
    x = torch.from_numpy(a["x"]).to(torch.bfloat16).requires_grad_(True)
    out = cs.fused_conv_stage(x, *(targs[k] for k in NAMES[1:]), external_first=True)
    ((out[0].float() * torch.from_numpy(a["cp"])).sum()
     + (out[1].float() * torch.from_numpy(a["ce"])).sum()).backward()
    for name, got, w in zip(("p", "e", "mean0", "var0", "mean1", "var1"), out, want):
        assert _rel(got.detach().float().numpy(), w) <= STAGE_TOL, name
    grads = {k: t.grad.numpy() for k, t in targs.items() if k != "w0"}
    grads["x"] = x.grad.float().numpy()
    for name, got in grads.items():
        assert _rel(got, want_g[name]) <= STAGE_TOL, name
    for k, edge in edges.items():
        for name in ("g0", "b0"):
            got, ref = grads[name][k], want_g[name][k]
            if edge[4] < 0:  # masked everywhere: no dy0 reaches the sums
                assert got == 0 and ref == 0, (edge[0], name)
            else:
                assert ref != 0 and abs(got - ref) <= STAGE_TOL * abs(ref), (edge[0], name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_backward_at_bf16_ties_matches_spcl_tpu(dtype):
    b, h, w, ci, c = 1, 10, 12, 16, 16
    dy, z, dcoef = bn_bwd_ties(b, h, w, c, seed=4)
    # spcl_tpu, eager: `_k_dz1` (:374) and `dz_rows` (:488-497, its row mask
    # 1.0 inside the image) on the operands as stored in `dtype`
    dc = jnp.asarray(dcoef)
    dyj, zj = (jnp.asarray(a).astype(dtype).astype(jnp.float32) for a in (dy, z))
    dz1_j = (dc[0] * dyj + dc[1] + dc[2] * zj).astype(dtype)
    dz0_j = ((dc[0] * dyj + dc[1] + dc[2] * zj) * jnp.float32(1.0)).astype(dtype)
    want = np.asarray(dz0_j.astype(jnp.float32))
    np.testing.assert_array_equal(np.asarray(dz1_j.astype(jnp.float32)), want)
    fused = fused_order(dy, z, dcoef)
    differs = (to_bf16(fused) if dtype == "bfloat16" else fused) != want
    assert differs.mean() > (0.4 if dtype == "bfloat16" else 0.99)

    tdtype = getattr(torch, dtype)
    dy_t, z_t, dc_t = torch.from_numpy(dy).to(tdtype), torch.from_numpy(z).to(tdtype), \
        torch.from_numpy(dcoef)
    coef = torch.stack([torch.ones(c), torch.zeros(c)])  # y1 = z1 >= 0: dy1 = de
    np.testing.assert_array_equal(cs.dz1_plain(z_t, coef, dc_t, None, dy_t).float().numpy(), want)
    # dz0 through dW0: x one-hot at pixel p_i in channel i gives
    # dW0[u, v, i] = dz0[p_i - (u-1, v-1)]
    x = torch.zeros(b, h, w, ci, dtype=tdtype)
    pix = [(1 + (3 * i) % (h - 2), 1 + (5 * i) % (w - 2)) for i in range(ci)]
    for i, (py, px) in enumerate(pix):
        x[0, py, px, i] = 1
    w0 = torch.randn(3, 3, ci, c, generator=torch.Generator().manual_seed(4)) / 12
    _, dw0 = cs.dwdx_plain(z_t, dy_t, dc_t, x, w0)
    taps = np.arange(3)
    for i, (py, px) in enumerate(pix):
        np.testing.assert_array_equal(dw0[:, :, i].numpy(),
                                      want[0][np.ix_(py + 1 - taps, px + 1 - taps)])
