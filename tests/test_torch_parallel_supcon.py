"""The row-strip self-paced SupCon and the collectives of spcl_torch against
spcl_tpu, on the CPU (the wrappers take the kernels' plain per-row versions
there; spcl_tpu's Pallas kernels run in interpret mode inside shard_map).

(a) One process walks the strips of R in {2, 4, 8} virtual ranks
    (`ops.supcon_cuda.walk_strips`): loss and ratio against
    `make_sharded_supcon_fn(make_mesh(8), use_fused=True)` and against the
    dense `self_paced_supcon_loss` of spcl_tpu, rtol 1e-5; dz1, dz2 against
    the dense loss's gradients, rtol 1e-4, atol 1e-6 (the tolerances of
    tests/test_parallel_fused.py: float32 sums in another order).
(b) 2 and 4 real ranks over gloo: the fused strip, the naive strip and the
    replicated form, values and gradients, against the port's single-process
    loss (same tolerances); the cross-rank BatchNorm against spcl_tpu's
    `TorchBatchNorm` on the concatenated batch (rtol 1e-5, atol 1e-6: one-pass
    float32 statistics summed per rank first).
Plus the launcher: a rank's exception and a rank that never arrives both fail
the caller within its time limit.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu.losses import self_paced_supcon_loss as jax_sp_loss
from spcl_tpu.losses import supcon_loss as jax_supcon_loss
from spcl_tpu.models.norm import TorchBatchNorm
from spcl_tpu.parallel import make_mesh, shard_batch
from spcl_tpu.parallel.contrastive import make_sharded_supcon_fn
from spcl_torch.losses.supcon import self_paced_supcon_loss
from spcl_torch.ops import supcon_cuda as sc
from spcl_torch.parallel import mesh
from spcl_torch.parallel.mesh import spawn_local

import torch_parallel_workers as workers

GAMMA = 3.5
MODES = [("soft", False), ("soft", True), ("hard", False), ("none", False)]
JOIN_S = 180.0


def _problem(n=32, d=16, seed=3, invalid_tail=3):
    """As tests/test_parallel_fused.py::_problem."""
    rng = np.random.RandomState(seed)
    z1 = rng.randn(n, d).astype(np.float32)
    z1 /= np.linalg.norm(z1, axis=1, keepdims=True)
    z2 = rng.randn(n, d).astype(np.float32)
    z2 /= np.linalg.norm(z2, axis=1, keepdims=True)
    labels = rng.randint(0, 4, n).astype(np.int32)
    valid = np.ones(n, np.float32)
    if invalid_tail:
        valid[-invalid_tail:] = 0.0
    return {"z1": z1, "z2": z2, "labels": labels, "valid": valid}


def _jax_dense(p, mode, correct_grad):
    """(loss, ratio, dz1, dz2) of spcl_tpu's dense loss."""
    def loss_fn(a, b):
        if mode == "none":
            loss, _ = jax_supcon_loss(a, b, target=jnp.asarray(p["labels"]),
                                      valid=jnp.asarray(p["valid"]))
            return loss, jnp.ones(())
        loss, aux = jax_sp_loss(a, b, gamma=GAMMA, target=jnp.asarray(p["labels"]),
                                valid=jnp.asarray(p["valid"]), weight_update=mode,
                                correct_grad=correct_grad)
        return loss, aux.downgrade_ratio
    (loss, ratio), (g1, g2) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(p["z1"]), jnp.asarray(p["z2"]))
    return float(loss), float(ratio), np.asarray(g1), np.asarray(g2)


@pytest.fixture(scope="module")
def jax_reference():
    """{(mode, correct_grad): dense and mesh-8 fused-strip results of spcl_tpu}."""
    assert len(jax.devices()) >= 8, jax.devices()
    mesh8 = make_mesh(8)
    p = _problem()
    sh = shard_batch({"z1": p["z1"], "z2": p["z2"], "t": p["labels"], "v": p["valid"]}, mesh8)
    out = {}
    for mode, correct_grad in MODES:
        fn = make_sharded_supcon_fn(mesh8, weight_update=mode, correct_grad=correct_grad,
                                    use_fused=True)
        loss, ratio = fn(sh["z1"], sh["z2"], sh["t"], sh["v"], jnp.asarray(GAMMA))
        out[(mode, correct_grad)] = {"dense": _jax_dense(p, mode, correct_grad),
                                     "strip": (float(loss), float(ratio))}
    return out


def _walk(p, world, mode, correct_grad):
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    return sc.walk_strips(t["z1"], t["z2"], t["labels"], t["valid"], world, gamma=GAMMA,
                          weight_update=mode, correct_grad=correct_grad)


# ------------------------------------------------------------------ (a) virtual ranks
@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("mode,correct_grad", MODES)
def test_virtual_strips_match_jax(jax_reference, world, mode, correct_grad):
    ref = jax_reference[(mode, correct_grad)]
    w = _walk(_problem(), world, mode, correct_grad)
    for name, (loss, ratio) in (("fused strip on mesh 8", ref["strip"]),
                                ("dense", ref["dense"][:2])):
        np.testing.assert_allclose(float(w["loss"]), loss, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(float(w["ratio"]), ratio, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(w["dz1"].numpy(), ref["dense"][2], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(w["dz2"].numpy(), ref["dense"][3], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("mode,correct_grad", [("soft", True), ("hard", False)])
def test_virtual_strips_batch_not_a_rank_multiple(world, mode, correct_grad):
    """n = 30 over 4 or 8 ranks: the batch is right-padded with valid=0
    entries to a rank multiple, as the trainers pad it; loss, ratio and the
    real rows' gradients equal the unpadded dense loss, pad rows get zero."""
    p = _problem(n=30, seed=5, invalid_tail=2)
    ref = _jax_dense(p, mode, correct_grad)
    pad = (-30) % world
    padded = {"z1": np.concatenate([p["z1"], np.repeat(p["z1"][:1], pad, 0)]),
              "z2": np.concatenate([p["z2"], np.repeat(p["z2"][:1], pad, 0)]),
              "labels": np.concatenate([p["labels"], np.full(pad, -1, np.int32)]),
              "valid": np.concatenate([p["valid"], np.zeros(pad, np.float32)])}
    w = _walk(padded, world, mode, correct_grad)
    np.testing.assert_allclose(float(w["loss"]), ref[0], rtol=1e-5)
    np.testing.assert_allclose(float(w["ratio"]), ref[1], rtol=1e-5)
    np.testing.assert_allclose(w["dz1"].numpy()[:30], ref[2], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(w["dz2"].numpy()[:30], ref[3], rtol=1e-4, atol=1e-6)
    assert not w["dz1"].numpy()[30:].any() and not w["dz2"].numpy()[30:].any()


def test_strip_operands_ids_and_order():
    """Row ids row_off + r and N + row_off + r, pad rows -1, pad columns -2,
    and the gathered statistics in global order (view 1 of every rank, then
    view 2): a rank-major order would pass at R = 1 and fail here."""
    p = _problem(n=12, invalid_tail=0)
    w = _walk(p, 4, "soft", False)
    for r, (rows, cols, stats_l, stats_g) in enumerate(w["strips"]):
        gid_r, gid_c = rows[3].numpy(), cols[3].numpy()
        assert gid_r.shape == (32,) and gid_c.shape == (32,)
        np.testing.assert_array_equal(gid_r[:6], [3 * r, 3 * r + 1, 3 * r + 2,
                                                  12 + 3 * r, 13 + 3 * r, 14 + 3 * r])
        assert (gid_r[6:] == -1).all()
        np.testing.assert_array_equal(gid_c[:24], np.arange(24))
        assert (gid_c[24:] == -2).all()
        assert (rows[1].numpy()[6:] == -7).all() and not rows[2].numpy()[6:].any()
        assert (cols[1].numpy()[24:] == -7).all() and not cols[2].numpy()[24:].any()
        # this rank's own statistics sit at its global row ids
        for k in range(3):
            np.testing.assert_array_equal(stats_g[k].numpy()[gid_r[:6].astype(int)],
                                          stats_l[k].numpy()[:6])
    x = torch.arange(12)  # ranks 0..1, n_local 3: [v1 r0, v2 r0, v1 r1, v2 r1]
    np.testing.assert_array_equal(sc.global_order(x, 2, 3).numpy(),
                                  [0, 1, 2, 6, 7, 8, 3, 4, 5, 9, 10, 11])


def test_single_process_sharded_equals_square_form():
    """Without a process group the strip code is the single-device loss."""
    p = _problem(seed=11)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    assert not mesh.active() and mesh.world_size() == 1 and mesh.on_master()
    outs = []
    for fn in (sc.sharded_fused_self_paced_supcon,
               lambda a, b, tt, v, **k: sc.fused_self_paced_supcon(a, b, target=tt, valid=v,
                                                                    **k)):
        a, b = t["z1"].clone().requires_grad_(True), t["z2"].clone().requires_grad_(True)
        loss, ratio = fn(a, b, t["labels"], t["valid"], gamma=GAMMA, weight_update="hard",
                         correct_grad=True)
        loss.backward()
        outs.append((float(loss.detach()), float(ratio), a.grad.numpy(), b.grad.numpy()))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-6)
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-6)
    np.testing.assert_allclose(outs[0][2], outs[1][2], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(outs[0][3], outs[1][3], rtol=1e-5, atol=1e-7)


def test_mesh_helpers_are_identity_without_a_group():
    x = torch.arange(6.0).reshape(3, 2).requires_grad_(True)
    assert mesh.all_gather_cat(x) is x and mesh.all_reduce_sum(x) is x
    assert mesh.grad_share(x) is x
    assert mesh.shard_rows({"a": x}, 3)["a"] is x
    mesh.host_barrier()
    mesh.all_reduce_grads([x])
    np.testing.assert_array_equal(mesh.pad_multiple(np.arange(5), 2), [0, 1, 2, 3, 4, -1])
    np.testing.assert_array_equal(mesh.pad_multiple(np.arange(6), 2), np.arange(6))
    assert mesh.pad_multiple(np.zeros((3, 5), np.int32), 8).shape == (3, 8)
    assert [mesh.requested_ranks(s, "cpu") for s in (0, None, False, 2, "4", "auto")] \
        == [1, 1, 1, 2, 4, 1]


# ------------------------------------------------------------------ (b) real ranks, gloo
LOSS_CASES = [(name, mode, cg) for name in workers.LOSSES
              for mode, cg in (("soft", False), ("hard", True))] + [("fused_strip", "none", False)]


def _bn_problem():
    rng = np.random.RandomState(7)
    return {"x": rng.randn(8, 5, 6, 6).astype(np.float32) * 2.0 + 0.5,
            "dy": rng.randn(8, 5, 6, 6).astype(np.float32),
            "weight": rng.uniform(0.5, 1.5, 5).astype(np.float32),
            "bias": rng.randn(5).astype(np.float32),
            "running_mean": rng.randn(5).astype(np.float32),
            "running_var": rng.uniform(0.5, 2.0, 5).astype(np.float32)}


@pytest.fixture(scope="module", params=[2, 4])
def rank_results(request):
    """(world, per-rank [supcon results, batchnorm results]) from one set of
    gloo ranks."""
    world = request.param
    bn = _bn_problem()
    calls = [("supcon_worker", (_problem(n=24), LOSS_CASES, GAMMA)),
             ("batchnorm_worker", tuple(bn[k] for k in ("x", "dy", "weight", "bias",
                                                        "running_mean", "running_var")))]
    return world, spawn_local(world, workers.run_calls, (calls,), device="cpu",
                              timeout_s=JOIN_S, collective_timeout_s=60.0)


@pytest.mark.parametrize("case", LOSS_CASES, ids=lambda c: f"{c[0]}-{c[1]}-cg{int(c[2])}")
def test_ranks_match_single_process_loss(rank_results, case):
    world, results = rank_results
    name, mode, correct_grad = case
    p = _problem(n=24)
    a = torch.from_numpy(p["z1"]).requires_grad_(True)
    b = torch.from_numpy(p["z2"]).requires_grad_(True)
    kw = dict(target=torch.from_numpy(p["labels"]), valid=torch.from_numpy(p["valid"]))
    if mode == "none":
        loss, ratio = sc.fused_supcon(a, b, **kw), torch.ones(())
    else:
        loss, aux = self_paced_supcon_loss(a, b, gamma=GAMMA, weight_update=mode,
                                           correct_grad=correct_grad, **kw)
        ratio = aux.downgrade_ratio
    loss.backward()
    for r in range(world):  # identical on every rank
        got = results[r][0][case]
        np.testing.assert_allclose(got[0], float(loss.detach()), rtol=1e-5)
        np.testing.assert_allclose(got[1], float(ratio), rtol=1e-5)
    # each rank holds the complete gradient of its own rows
    g1 = np.concatenate([results[r][0][case][2] for r in range(world)])
    g2 = np.concatenate([results[r][0][case][3] for r in range(world)])
    np.testing.assert_allclose(g1, a.grad.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g2, b.grad.numpy(), rtol=1e-4, atol=1e-6)


def test_cross_rank_batchnorm_matches_jax(rank_results):
    world, results = rank_results
    p = _bn_problem()
    bn = TorchBatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(p["weight"]), "bias": jnp.asarray(p["bias"])},
                 "batch_stats": {"mean": jnp.asarray(p["running_mean"]),
                                 "var": jnp.asarray(p["running_var"])}}
    x = jnp.asarray(np.transpose(p["x"], (0, 2, 3, 1)))       # NHWC
    dy = jnp.asarray(np.transpose(p["dy"], (0, 2, 3, 1)))

    def loss_fn(params, xx):
        y, new = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y * dy), (y, new["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
        variables["params"], x)
    nchw = lambda t: np.transpose(np.asarray(t), (0, 3, 1, 2))
    tol = dict(rtol=1e-5, atol=1e-6)
    got = [r[1] for r in results]
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got]), nchw(y), **tol)
    np.testing.assert_allclose(np.concatenate([g["dx"] for g in got]), nchw(gx),
                               rtol=1e-4, atol=1e-5)
    # the ranks' weight gradients SUM to the global gradient (mesh.py's convention)
    np.testing.assert_allclose(sum(g["dweight"] for g in got), np.asarray(gp["scale"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sum(g["dbias"] for g in got), np.asarray(gp["bias"]),
                               rtol=1e-4, atol=1e-5)
    ev = TorchBatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5)
    y_eval = ev.apply({"params": variables["params"], "batch_stats": stats}, x)
    for g in got:  # identical running statistics on every rank
        np.testing.assert_allclose(g["running_mean"], np.asarray(stats["mean"]), **tol)
        np.testing.assert_allclose(g["running_var"], np.asarray(stats["var"]), **tol)
        assert g["tracked"] == 1
    np.testing.assert_allclose(np.concatenate([g["y_eval"] for g in got]), nchw(y_eval), **tol)


def test_batchnorm_without_group_is_nn_batchnorm():
    from spcl_torch.models.norm import BN_EPS, batch_norm
    p = _bn_problem()
    ours, ref = batch_norm(5), torch.nn.BatchNorm2d(5, eps=BN_EPS, momentum=0.1)
    assert isinstance(ours, torch.nn.BatchNorm2d)
    assert list(ours.state_dict()) == list(ref.state_dict())
    x = torch.from_numpy(p["x"])
    np.testing.assert_array_equal(ours(x).detach().numpy(), ref(x).detach().numpy())
    np.testing.assert_array_equal(ours.running_var.numpy(), ref.running_var.numpy())


# ------------------------------------------------------------------ the launcher
def test_a_ranks_exception_reaches_the_caller():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn_local(2, workers.failing_worker, device="cpu", timeout_s=JOIN_S,
                    collective_timeout_s=60.0)
    assert time.monotonic() - t0 < 60.0


def test_a_rank_that_never_arrives_fails_the_caller_in_time():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="not done after"):
        spawn_local(2, workers.hanging_worker, device="cpu", timeout_s=6.0,
                    collective_timeout_s=60.0)
    assert time.monotonic() - t0 < 40.0
