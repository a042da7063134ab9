"""The semi, mixup, adversarial and decoder-pretrain trainers of spcl_torch
under a mesh, on the CPU over gloo: spcl_tpu runs them under its `data`
mesh with global-batch semantics (tests/test_mesh_trainer.py), and 2 ranks
of the port must equal one process.

Two ranks run every scenario in one set of processes
(torch_parallel_workers.semi_worker); this process runs the same padded
global batches and the same draws (one generator, drawn for the global
batch) alone. UNet-32, crop 32 of a 48 canvas, torch on one thread:
- the semi step, 2 steps of mean teacher + consistency and 1 step each of
  entropy minimisation, UC-MT, IIC at Conv5, dense IIC (`udaiic`), MIDL,
  MINE, the mixup branch and an `infonce` hook under both
  `global_contrast` values (4 labeled + 3 unlabeled slices padded to 4);
- the mixup trainer's fine-tune step with its hook, alpha 1 and 0.4;
- the adversarial step (`reg_weight` 0.5, `dis_consider_image`; one step,
  see `run_adversarial_step`);
- a `pretrain_decoder` step under both `global_contrast` values (dense
  InfoNCE at Up_conv3, 9 slices padded to 10);
- the semi trainer through `build_trainer`: 2 epochs, and 1 epoch +
  `trainer_checkpoint` resume + 1 epoch, and 2 epochs with `defer_reads`.
Held at tests/test_torch_parallel_trainer.py's tolerances: losses and hook
metrics rtol 1e-5 (hook metrics also atol 1e-6: IIC's mutual information of
a random head is ~1e-5, a difference of terms of order log K), parameters,
BatchNorm buffers, the projectors' gradients and the discriminator's Adam
moments rtol 1e-4, atol 1e-6; per-slice Dice counts within 2 pixels of a
32x32 slice (an argmax near-tie the rounding of the other summation order
breaks the other way). The replicas agree to the bit, and so does the
resumed mesh run with the uninterrupted one, and `defer_reads` with eager.

Against spcl_tpu under `make_mesh(2)` on the virtual CPU devices (GSPMD,
one step from transplanted weights with spcl_tpu's own draws injected):
the semi step with mean teacher + consistency + IIC at Conv5, the
adversarial step and the decoder-pretrain step under `row_sharded`, at the
tolerances of tests/test_torch_semi_step.py, test_torch_adversarial.py and
test_torch_decoder_pretrain.py.

And `spcl_torch.main.main` (`python -m spcl_torch.main --device cpu`) with
`Trainer.mesh=2` at a tiny config against the same arguments without a mesh.
"""
import dataclasses
import multiprocessing as mp
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spcl_tpu.data import augment as jaug
from spcl_tpu.data import packing as jpacking
from spcl_tpu.data.creator import create_contrastive_loader as jax_contrastive_loader
from spcl_tpu.hooks import creator as jcreator
from spcl_tpu.hooks.base import get_individual_hooks as jax_individual_hooks
from spcl_tpu.hooks.infonce import INFONCEHook as JaxHook
from spcl_tpu.models.discriminator import Discriminator as JaxDiscriminator
from spcl_tpu.models.masking import stage_trainable_mask
from spcl_tpu.models.unet import UNet as JaxUNet
from spcl_tpu.parallel import make_mesh, replicate, shard_batch
from spcl_tpu.training.optim import build_optimizer as jax_build_optimizer
from spcl_tpu.training.state import create_train_state
from spcl_tpu.training.steps import build_adversarial_step as jax_build_adversarial_step
from spcl_tpu.training.steps import build_pretrain_step as jax_build_pretrain_step
from spcl_tpu.training.steps import build_semi_step as jax_build_semi_step
from spcl_torch.data.creator import create_contrastive_loader
from spcl_torch.data.packing import synthetic_dataset
from spcl_torch.models import UNet, head_state_dict_from_flax, unet_state_dict_from_flax
from spcl_torch.models.masking import stages_from_range
from spcl_torch.parallel.mesh import spawn_local
from spcl_torch.training import load_checkpoint, load_model_state_dict

import torch_parallel_workers as workers
from test_torch_decoder_pretrain import DEEP_CAP, NEAR_CAP, _dense_head_params
from test_torch_port_model import random_flax_unet
from test_torch_semi_step import _zero_stats
from test_torch_semi_trainer import _assert_same
from torch_port_helpers import jax_adversarial_draws, jax_semi_draws, jax_step_draws

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 300.0
RANKS = 2
RTOL_LOSS, RTOL_PARAM, ATOL_PARAM = 1e-5, 1e-4, 1e-6
METRIC_ATOL = 1e-6
COUNT_ATOL = 2.0
SEMI_SCENARIOS = list(workers.semi_scenarios())


def _in_own_process(fn, *args):
    """`fn(*args)` started in a fresh process (no process group: the plain
    single-process path); returns a callable that waits for its result."""
    pool = mp.get_context("spawn").Pool(1)
    pending = pool.apply_async(fn, args)

    def result():
        try:
            return pending.get(timeout=JOIN_S)
        finally:
            pool.terminate()
            pool.join()
    return result


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(mesh_runs, single_runs): the 2 ranks, and beside them the single
    process in a process of its own."""
    mesh_dir, single_dir = tmp_path_factory.mktemp("mesh"), tmp_path_factory.mktemp("single")
    single = _in_own_process(workers.semi_rank_worker, str(single_dir), 1)
    ranks = spawn_local(RANKS, workers.semi_rank_worker, (str(mesh_dir), RANKS), device="cpu",
                        timeout_s=JOIN_S, collective_timeout_s=120.0)
    return (mesh_dir, ranks), (single_dir, single())


@pytest.fixture(scope="module")
def mesh_runs(runs):
    """Per-rank {scenario: result} of the 2-rank runs."""
    return runs[0]


@pytest.fixture(scope="module")
def single_runs(runs):
    return runs[1]


def _close_metrics(got, want, what):
    for k, v in want.items():
        if k == "hooks":
            assert sorted(got[k]) == sorted(v), what
            for name, m in v.items():
                assert sorted(got[k][name]) == sorted(m), (what, name)
                for mk, mv in m.items():
                    np.testing.assert_allclose(got[k][name][mk], mv, rtol=RTOL_LOSS,
                                               atol=METRIC_ATOL, err_msg=f"{what} {name}/{mk}")
        elif k in ("inter", "union"):
            assert got[k].shape == np.shape(v), (what, k)
            np.testing.assert_allclose(got[k], v, rtol=0, atol=COUNT_ATOL, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(got[k], v, rtol=RTOL_LOSS, err_msg=f"{what} {k}")


def _close_arrays(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL_PARAM, atol=ATOL_PARAM,
                                   err_msg=f"{what} {k}")


def _equal_tree(a, b, what):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _equal_tree(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_tree(x, y, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def _check_scenario(mesh_runs, single_runs, name, array_keys):
    one = single_runs[1][name]
    for r in range(RANKS):
        got = mesh_runs[1][r][name]
        assert len(got["metrics"]) == len(one["metrics"])
        for step, (g, w) in enumerate(zip(got["metrics"], one["metrics"])):
            _close_metrics(g, w, f"{name} rank {r} step {step}")
        for key in array_keys:
            if one.get(key) is not None:
                _close_arrays(got[key], one[key], f"{name} rank {r} {key}")
    # the replicas hold the same bits
    _equal_tree(mesh_runs[1][0][name], mesh_runs[1][1][name], name)


@pytest.mark.parametrize("name", SEMI_SCENARIOS)
def test_mesh_semi_step_matches_single_process(mesh_runs, single_runs, name):
    _check_scenario(mesh_runs, single_runs, f"semi_{name}",
                    ("weights", "teacher", "hook_grads"))
    one = single_runs[1][f"semi_{name}"]
    assert all(np.isfinite(m["reg_loss"]) for m in one["metrics"])


def test_semi_projectors_and_teacher_move(single_runs):
    """The scenarios exercise what they claim: projectors with non-zero
    gradients, a teacher that moved, UC-MT's gate open and shut."""
    runs = single_runs[1]
    assert any(np.abs(g).max() > 0 for g in runs["semi_mine"]["hook_grads"].values())
    assert any(np.abs(g).max() > 0 for g in runs["semi_udaiic"]["hook_grads"].values())
    ratio = float(runs["semi_ucmeanteacher"]["metrics"][0]["hooks"]["ucmt"]["uc_ratio"])
    assert 0.0 < ratio < 1.0
    assert "mix_reg" in runs["semi_mixup"]["metrics"][0]["hooks"]
    assert runs["semi_mt_uda"]["teacher"] is not None


@pytest.mark.parametrize("alpha", [1.0, 0.4])
def test_mesh_mixup_finetune_step_matches_single_process(mesh_runs, single_runs, alpha):
    _check_scenario(mesh_runs, single_runs, f"finetune_mixup_{alpha}", ("weights",))


def test_mesh_adversarial_step_matches_single_process(mesh_runs, single_runs):
    """The discriminator's summed gradients, through its Adam's first
    moments ((1 - b1) g) at the parameters' tolerance; its weights by their
    update within 1e-2 relative L2: Adam's first step moves a weight by about
    lr x sign(g), and where g sits at its own rounding noise the two
    summation orders move it 2 lr apart (tests/test_torch_adversarial.py)."""
    _check_scenario(mesh_runs, single_runs, "adversarial", ("weights",))
    one = single_runs[1]["adversarial"]
    d0 = workers.initial_discriminator()
    for r in range(RANKS):
        got = mesh_runs[1][r]["adversarial"]
        for g, w in zip(got["d_moments"], one["d_moments"]):
            np.testing.assert_allclose(g, w, rtol=RTOL_PARAM, atol=ATOL_PARAM)
        for k, w in one["discriminator"].items():
            assert _rel(got["discriminator"][k] - d0[k], w - d0[k]) <= 1e-2, (r, k)
    assert all(m["dis_loss"] > 0 and m["gen_loss"] > 0 for m in one["metrics"])


@pytest.mark.parametrize("contrast", ["replicated", "row_sharded"])
def test_mesh_decoder_pretrain_step_matches_single_process(mesh_runs, single_runs, contrast):
    _check_scenario(mesh_runs, single_runs, f"decoder_{contrast}", ("weights",))


def test_decoder_row_sharded_equals_replicated(mesh_runs):
    for r in range(RANKS):
        a = mesh_runs[1][r]["decoder_row_sharded"]
        b = mesh_runs[1][r]["decoder_replicated"]
        for g, w in zip(a["metrics"], b["metrics"]):
            _close_metrics(g, w, f"rank {r}")
        _close_arrays(a["weights"], b["weights"], f"rank {r}")


# ------------------------------------------------------------------ the semi trainer
def _trainer_runs(runs, r=None):
    return runs[1]["trainer"] if r is None else runs[1][r]["trainer"]


def test_mesh_semi_trainer_matches_single_process(mesh_runs, single_runs):
    one = _trainer_runs(single_runs)["full"]
    assert one["n_shards"] == 1 and len(one["steps"]) == 4
    for r in range(RANKS):
        got = _trainer_runs(mesh_runs, r)["full"]
        assert got["n_shards"] == RANKS
        for g, w in zip(got["steps"], one["steps"]):
            assert g["epoch"] == w["epoch"]
            _close_metrics({k: v for k, v in g.items() if k != "epoch"},
                           {k: v for k, v in w.items() if k != "epoch"}, f"rank {r}")
        np.testing.assert_allclose(got["score"], one["score"], rtol=RTOL_LOSS)
        for key in ("val/loss/mean", "val/dice/DSC_mean", "tra/sup_dice/DSC_mean"):
            np.testing.assert_allclose(got["history"][2][key], one["history"][2][key],
                                       rtol=RTOL_LOSS, err_msg=key)
        _close_arrays(got["weights"], one["weights"], f"rank {r} student")
        _close_arrays(got["teacher"], one["teacher"], f"rank {r} teacher")
    _equal_tree(_trainer_runs(mesh_runs, 0)["full"]["weights"],
                _trainer_runs(mesh_runs, 1)["full"]["weights"], "replicas")
    _equal_tree(_trainer_runs(mesh_runs, 0)["full"]["teacher"],
                _trainer_runs(mesh_runs, 1)["full"]["teacher"], "teacher replicas")


def _without_rates(storage):
    for row in storage["history"].values():
        for k in [k for k in row if "throughput" in k]:
            del row[k]
    return storage


def test_mesh_resume_equals_an_uninterrupted_mesh_run(mesh_runs):
    """To the bit: every rank loads rank 0's epoch-1 checkpoint (student,
    teacher, RAdam, the projectors-free hooks' schedulers, the generator and
    the samplers) and continues as the uninterrupted run did."""
    for r in range(RANKS):
        runs = _trainer_runs(mesh_runs, r)
        assert runs["resumed_at"] == 1
        assert [m["epoch"] for m in runs["resumed"]["steps"]] == [2, 2]
        assert runs["resumed"]["steps"] == runs["full"]["steps"][2:]
        _equal_tree(runs["resumed"]["weights"], runs["full"]["weights"], f"rank {r} student")
        _equal_tree(runs["resumed"]["teacher"], runs["full"]["teacher"], f"rank {r} teacher")
    a = load_checkpoint(str(mesh_runs[0] / "full" / "rank0" / "last.ckpt"))
    b = load_checkpoint(str(mesh_runs[0] / "resumed" / "rank0" / "last.ckpt"))
    for key in ("_model", "_optimizer", "_teacher", "_hook_states", "_generator", "_samplers",
                "cur_epoch", "best_score"):
        _assert_same(a[key], b[key], key)
    _assert_same(_without_rates(a["storage"]), _without_rates(b["storage"]), "storage")
    assert b["_teacher"]["step"] == 4 and b["_hook_states"]["ucmt"]["threshold"]["epoch"] == 2


def test_mesh_defer_reads_equals_eager(mesh_runs):
    for r in range(RANKS):
        runs = _trainer_runs(mesh_runs, r)
        assert runs["deferred"]["score"] == runs["full"]["score"]
        _equal_tree(runs["deferred"]["weights"], runs["full"]["weights"], f"rank {r}")
        _equal_tree(runs["deferred"]["teacher"], runs["full"]["teacher"], f"rank {r}")
        assert [m["sup_loss"] for m in runs["deferred"]["steps"]] == \
            [m["sup_loss"] for m in runs["full"]["steps"]]
    _assert_same(load_checkpoint(str(mesh_runs[0] / "deferred" / "rank0" / "best.ckpt"))["_model"],
                 load_checkpoint(str(mesh_runs[0] / "full" / "rank0" / "best.ckpt"))["_model"],
                 "best.ckpt")


def test_mesh_semi_files_from_rank_0_and_checkpoints_load_strictly(mesh_runs):
    """(A resumed run writes best.ckpt only if epoch 2 beats the restored best.)"""
    for run in ("full", "resumed", "deferred"):
        files = [f for f in _trainer_runs(mesh_runs, 0)[run]["files"]
                 if not f.startswith("events.out")]
        want = {".success", "config.yaml", "last.ckpt", "storage.csv"}
        assert want | ({"best.ckpt"} if run == "full" else set()) <= set(files), run
        assert _trainer_runs(mesh_runs, 1)[run]["files"] == [], run
        sd = load_model_state_dict(str(mesh_runs[0] / run / "rank0" / "last.ckpt"))
        UNet(max_channel=workers.SEMI_MAXC).load_state_dict(sd, strict=True)


# ------------------------------------------------------------------ against spcl_tpu
def _unet_pair(seed):
    params, stats = random_flax_unet(np.random.default_rng(seed), max_channel=128)
    return params, stats, unet_state_dict_from_flax(params, stats)


def _batches(sizes, seed):
    """The same global index vectors from both packages' synthetic
    datasets, the last row of the last one padding."""
    jds = jpacking.synthetic_dataset("acdc", num_scans=4, canvas=workers.CANVAS, seed=0)
    pds = synthetic_dataset("acdc", num_scans=4, canvas=workers.CANVAS, seed=0)
    rng = np.random.default_rng(seed)
    idx = [rng.choice(len(pds.images), n, replace=False) for n in sizes]
    idx[-1][-1] = -1
    return ([jax.tree_util.tree_map(jnp.asarray, jds.batch(i)) for i in idx],
            [dict(pds.batch(i)) for i in idx])


def _check_unet(got, flax_params, flax_stats, atol, what):
    """Parameters atol `atol`; running statistics (where `flax_stats` is
    given: the teacher holds parameters only) rtol 1e-3, atol 1e-4."""
    want = unet_state_dict_from_flax(flax_params, flax_stats or _zero_stats(flax_params))
    for k, v in want.items():
        if "num_batches" in k or ("running" in k and flax_stats is None):
            continue
        if "running" in k:
            np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=1e-4, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=atol, err_msg=f"{what} {k}")


MT_UDA_IIC = (("create_mt_hook", {"weight": 10.0}),
              ("create_discrete_mi_consistency_hook",
               {"feature_names": ["Conv5"], "mi_weights": 0.1, "consistency_weight": 5.0}))
IIC = "discreteMI/conv5"


def _jax_semi(mesh2):
    """Mean teacher (10) + consistency (5) + IIC at Conv5 (0.1), UNet-128,
    4 labeled + 4 unlabeled slices (one padded), RAdam at lr 1e-3."""
    params, stats, state_dict = _unet_pair(0)
    jpol = dataclasses.replace(jaug.ACDC_LABEL, crop=workers.CROP)
    jhooks = jax_individual_hooks(*[getattr(jcreator, f)(**kw) for f, kw in MT_UDA_IIC])
    iic = [h for h in jhooks if h.name == IIC][0]
    head = jax.device_get(iic.build(jax.random.PRNGKey(1), None,
                                    {"Conv5": jnp.zeros((2, 2, 2, 128), jnp.float32)}))
    tx = jax_build_optimizer(name="RAdam", lr=workers.SEMI_LR, weight_decay=workers.SEMI_WD)
    state = create_train_state(model_params=params, batch_stats=stats, hook_params={IIC: head},
                               tx=tx, teacher=True)
    jstep = jax_build_semi_step(JaxUNet(input_dim=1, num_classes=4, max_channel=128), jhooks,
                                tx, num_classes=4, policy=jpol, mesh=mesh2)
    (jl, ju), (pl, pu) = _batches((4, 4), seed=21)
    key = jax.random.PRNGKey(7)
    draws = jax_semi_draws(key, 4, 4, jpol, workers.CANVAS, jl["size"], ju["size"],
                           hooks=jhooks)

    def run():
        return jstep(replicate(state, mesh2), shard_batch(jl, mesh2), shard_batch(ju, mesh2),
                     replicate(key, mesh2), {})
    return {"jax": run,
            "args": (list(MT_UDA_IIC), state_dict, {IIC: head_state_dict_from_flax(head)},
                     pl, pu, draws, {})}


def _jax_adversarial(mesh2):
    """`reg_weight` 0.5 with `dis_consider_image`, UNet-128, 4 + 4 slices
    (one padded), the discriminator's Adam at lr 1e-4, b1 0.5."""
    params, stats, state_dict = _unet_pair(4)
    jd = JaxDiscriminator(base_channels=64)
    dvars = jax.device_get(jd.init(jax.random.PRNGKey(9),
                                   jnp.zeros((2, workers.CROP, workers.CROP, 5))))
    jpol = dataclasses.replace(jaug.ACDC_LABEL, crop=workers.CROP)
    tx = jax_build_optimizer(name="RAdam", lr=workers.SEMI_LR, weight_decay=workers.SEMI_WD)
    dtx = optax.adam(1e-4, b1=0.5, b2=0.999)
    state = create_train_state(model_params=params, batch_stats=stats, hook_params={}, tx=tx,
                               discr_params=dvars, discr_tx=dtx)
    jstep = jax_build_adversarial_step(JaxUNet(input_dim=1, num_classes=4, max_channel=128),
                                       jd, tx, dtx, num_classes=4, policy=jpol,
                                       reg_weight=0.5, dis_consider_image=True)
    (jl, ju), (pl, pu) = _batches((4, 4), seed=31)
    key = jax.random.PRNGKey(17)
    draws = jax_adversarial_draws(key, 4, 4, jpol, workers.CANVAS, jl["size"], ju["size"])

    def run():
        return jstep(replicate(state, mesh2), shard_batch(jl, mesh2), shard_batch(ju, mesh2),
                     replicate(key, mesh2))
    d_before = head_state_dict_from_flax(dvars)
    return {"jax": run, "d_before": d_before, "args": (state_dict, d_before, pl, pu, draws, 0.5)}


def _jax_decoder(mesh2):
    """Dense InfoNCE at Up_conv3 (`contrast_on: self`, row_sharded), UNet-128,
    2 scans x 3 partitions, RAdam at lr 1e-3 with weight decay 1e-2."""
    params, stats, state_dict = _unet_pair(5)
    head = _dense_head_params(np.random.default_rng(6),
                              UNet(max_channel=128).channel_dim("Up_conv3"))
    jhook = JaxHook(name=workers.DECODER_HOOK, feature_name="Up_conv3", contrast_on="self",
                    global_contrast="row_sharded")
    jpol = dataclasses.replace(jaug.ACDC_PRETRAIN, crop=workers.CROP)
    tx = jax_build_optimizer(name="RAdam", lr=workers.SEMI_LR, weight_decay=1e-2)
    mask = stage_trainable_mask(params, stages_from_range("Conv5", "Up_conv3"))
    state = create_train_state(model_params=params, batch_stats=stats,
                               hook_params={workers.DECODER_HOOK: head}, tx=tx)
    jstep = jax_build_pretrain_step(JaxUNet(input_dim=1, num_classes=4, max_channel=128),
                                    [jhook], tx, policy=jpol, total_freedom=False,
                                    until="Up_conv3", grad_mask=mask, mesh=mesh2)
    jds = jpacking.synthetic_dataset("acdc", num_scans=4, canvas=workers.CANVAS, seed=0)
    pds = synthetic_dataset("acdc", num_scans=4, canvas=workers.CANVAS, seed=0)
    jb = jax.tree_util.tree_map(
        jnp.asarray, next(iter(jax_contrastive_loader(jds, scan_sample_num=2, seed=3))))
    pb = dict(next(iter(create_contrastive_loader(pds, scan_sample_num=2, seed=3))))
    n = jb["image"].shape[0]
    assert n == 6
    key = jax.random.PRNGKey(11)
    draws = jax_step_draws(key, n, jpol, workers.CANVAS, sizes=jb["size"],
                           total_freedom=False, hooks=[jhook])

    def run():
        return jstep(replicate(state, mesh2), shard_batch(jb, mesh2), replicate(key, mesh2), {})
    head_state = head_state_dict_from_flax(head)
    return {"jax": run, "state_dict": state_dict, "head": head_state,
            "args": (state_dict, head_state, pb, draws, "row_sharded")}


@pytest.fixture(scope="module")
def jax_parity():
    """spcl_tpu's semi, adversarial and decoder-pretrain steps under
    make_mesh(2), then the port's from the same weights, batches and draws
    on 2 ranks (one set of processes; the replicas agree to the bit), and
    the decoder step in this process too."""
    mesh2 = make_mesh(2)
    runs = {"semi": _jax_semi(mesh2), "adversarial": _jax_adversarial(mesh2),
            "decoder": _jax_decoder(mesh2)}
    calls = [(f"{name}_parity_worker", run["args"]) for name, run in runs.items()]
    with ThreadPoolExecutor(1) as pool:  # the ranks compute while spcl_tpu compiles
        ranks = pool.submit(spawn_local, RANKS, workers.run_calls, (calls,), device="cpu",
                            timeout_s=JOIN_S, collective_timeout_s=120.0)
        for run in runs.values():
            run["new"], run["jm"] = jax.device_get(run.pop("jax")())
        ranks = ranks.result()
    _equal_tree(ranks[0], ranks[1], "replicas")
    for run, got in zip(runs.values(), ranks[0]):
        run["got"] = got
    threads = torch.get_num_threads()
    try:  # no process group here: the plain path
        runs["decoder"]["single"] = workers.decoder_parity_worker(*runs["decoder"]["args"])
    finally:
        torch.set_num_threads(threads)
    return runs


def test_two_rank_semi_step_matches_jax_mesh_step(jax_parity):
    """The metrics rtol 1e-4 (atol 1e-7), Dice counts within 8 pixels, the
    student, the teacher and the IIC head after the step atol 2e-5, the
    running statistics rtol 1e-3, atol 1e-4 (tests/test_torch_semi_step.py)."""
    run = jax_parity["semi"]
    got, new, jm = run["got"], run["new"], run["jm"]
    pm = got["metrics"]
    for k in ("sup_loss", "reg_loss"):
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=k)
    assert sorted(pm["hooks"]) == sorted(jm["hooks"]) == ["consistency", IIC, "mt"]
    for name, m in jm["hooks"].items():
        for k, v in m.items():
            np.testing.assert_allclose(pm["hooks"][name][k], v, rtol=1e-4, atol=1e-7,
                                       err_msg=f"{name}/{k}")
    for k in ("inter", "union"):
        np.testing.assert_allclose(pm[k], jm[k], rtol=0, atol=8.0, err_msg=k)
    _check_unet(got["weights"], new.params["model"], new.batch_stats, 2e-5, "student")
    _check_unet(got["teacher"], new.teacher_params, None, 2e-5, "teacher")
    for k, v in head_state_dict_from_flax(new.params["hooks"][IIC]).items():
        np.testing.assert_allclose(got["weights"][f"hook:{IIC}.{k}"], v, rtol=0, atol=2e-5,
                                   err_msg=k)


def test_two_rank_adversarial_step_matches_jax_mesh_step(jax_parity):
    """sup_loss, gen_loss, dis_loss rtol 1e-4; the student atol 2e-5; the
    discriminator's summed gradients, scaled by reg_weight, against the
    gradients spcl_tpu's Adam saw (its first moment / (1 - b1)) within 2e-4
    relative L2, and its update within 1e-2 relative L2
    (tests/test_torch_adversarial.py)."""
    run = jax_parity["adversarial"]
    got, new, jm, d_before = run["got"], run["new"], run["jm"], run["d_before"]
    for k in ("sup_loss", "gen_loss", "dis_loss"):
        np.testing.assert_allclose(got["metrics"][k], jm[k], rtol=1e-4, atol=1e-7, err_msg=k)
    _check_unet(got["weights"], new.params["model"], new.batch_stats, 2e-5, "student")
    mu = head_state_dict_from_flax(new.discr_opt_state[0].mu)
    for k, v in head_state_dict_from_flax(new.discr_params).items():
        assert _rel(got["d_grads"][k], mu[k] / (1 - 0.5)) <= 2e-4, k
        assert _rel(got["weights"][f"discriminator.{k}"] - d_before[k], v - d_before[k]) <= 1e-2, k


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_two_rank_decoder_pretrain_step_matches_jax_mesh_step(jax_parity):
    """The loss rtol 1e-4; the updates of the head and Up_conv3 within 5e-4
    relative L2 and of Conv5..Up3 within 5e-2 (tests/test_torch_decoder_
    pretrain.py's caps: spcl_tpu's own decoder updates move that much under
    1e-6 of input noise; spcl_tpu's frozen stages drift under its weight
    decay, ROADMAP C8, so only the trained leaves are compared); and the 2
    ranks' updates against the port's single process, the head and Up_conv3
    within 1e-4, Conv5..Up3 within 1e-3 (measured at most 1.7e-4, Conv5's
    BatchNorm at 2x2 pixels: the cross-rank E[x^2] - mean^2 against one
    process's two-pass variance)."""
    run = jax_parity["decoder"]
    got, single, new, jm = run["got"], run["single"], run["new"], run["jm"]
    state_dict, head_state, hook_name = run["state_dict"], run["head"], workers.DECODER_HOOK
    np.testing.assert_allclose(got["metrics"]["reg_loss"], jm["reg_loss"], rtol=1e-4)
    after = unet_state_dict_from_flax(new.params["model"], _zero_stats(new.params["model"]))
    trained = ("Conv5", "Up5", "Up_conv5", "Up4", "Up_conv4", "Up3", "Up_conv3")
    want = {k: after[k] - state_dict[k] for k in after
            if k.split(".")[0][1:] in trained and "running" not in k and "num_batches" not in k}
    h1 = head_state_dict_from_flax(new.params["hooks"][hook_name])
    want.update({f"hook:{hook_name}.{k}": h1[k] - head_state[k] for k in h1})
    assert len(want) == 4 * 6 + 3 * 3 + 4

    def before(k):
        return head_state[k.split(".", 1)[1]] if k.startswith("hook:") else state_dict[k]

    rels = {}
    for k, w in want.items():
        near = k.startswith("hook:") or k.startswith("_Up_conv3.")
        update = got["weights"][k] - before(k)
        rels[k] = (_rel(update, w), NEAR_CAP if near else DEEP_CAP)
        rels[k + " (2 ranks vs 1)"] = (_rel(update, single["weights"][k] - before(k)),
                                       1e-4 if near else 1e-3)
    assert all(rel <= tol for rel, tol in rels.values()), \
        " ".join(f"{k}={rel:.1e}/{tol:.0e}" for k, (rel, tol) in rels.items())


# ------------------------------------------------------------------ the entry point
def test_main_entry_point_mesh_matches_single_process(tmp_path):
    """`spcl_torch.main.main([... Trainer.mesh=2], device="cpu")`, the
    `python -m spcl_torch.main --device cpu` entry (mean teacher +
    consistency), starts its 2 ranks itself; against the same arguments
    without a mesh (in a process of its own, beside it): the best val DSC
    rtol 1e-5 and the student's Conv1 kernel rtol 1e-4, atol 1e-6; rank 0
    wrote the run's files."""
    from spcl_torch.main import main
    small = ["Data.synthetic=true", f"Data.canvas={workers.CANVAS}", f"Data.crop={workers.CROP}",
             f"Arch.max_channel={workers.SEMI_MAXC}", "Data.synthetic_scans=4",
             "Data.synthetic_test_scans=3", "Data.labeled_scan_num=2", "Trainer.num_batches=2",
             "Trainer.max_epoch=1", "LabeledLoader.batch_size=4", "UnlabeledLoader.batch_size=4",
             "Optim.lr=1e-4", "Trainer.name=semi"]
    opt = ["--opt-path", str(ROOT / "config" / "specific" / "mt.yaml"),
           str(ROOT / "config" / "specific" / "uda.yaml")]
    one = _in_own_process(workers.main_entry,
                          [*small, f"Trainer.save_dir={tmp_path / 'single'}", *opt])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        two = main([*small, "Trainer.mesh=2", f"Trainer.save_dir={tmp_path / 'mesh'}", *opt],
                   device="cpu")
    finally:
        torch.set_num_threads(threads)
    one = one()
    assert 0.0 <= two <= 1.0
    np.testing.assert_allclose(two, one, rtol=1e-5, atol=1e-7)
    a = load_model_state_dict(str(tmp_path / "mesh" / "last.ckpt"))
    b = load_model_state_dict(str(tmp_path / "single" / "last.ckpt"))
    np.testing.assert_allclose(a["_Conv1.conv.0.weight"].numpy(),
                               b["_Conv1.conv.0.weight"].numpy(), rtol=1e-4, atol=1e-6)
    for f in (".success", "storage.csv", "best.ckpt", "run.log"):
        assert (tmp_path / "mesh" / f).exists(), f
