"""Multi-rank training through spcl_torch's trainers, on the CPU over gloo,
mirroring tests/test_mesh_trainer.py and tests/test_mesh_smoke.py of spcl_tpu.

Two ranks run every scenario in one set of processes
(torch_parallel_workers.trainer_worker); this process runs the same
configurations alone. Held:
- pretrain `replicated` = `row_sharded` = single process: reg_loss and
  sp_weight per step rtol 1e-5, the first Conv5 kernel rtol 1e-4, atol 1e-6
  (the tolerances of tests/test_mesh_trainer.py:76-127; the cross-rank
  BatchNorm sums its float32 statistics per rank first);
- fine-tune = single process (batch 8 over 2 ranks): sup_loss, val loss and
  the best score rtol 1e-5, the first Conv1 kernel rtol 1e-4, atol 1e-6;
- a batch of 5 padded to 6 finishes with finite metrics and a DSC in [0, 1]
  (a pad row enters the BatchNorm statistics, so no equality is asked);
- `small_c_layout: pallas` is refused under a mesh; files come from rank 0
  only; a mesh run's checkpoints load strictly into a single-process model;
- one 2-rank pretrain step on a fixed batch with injected draws against
  spcl_tpu's step under `make_mesh(8)` from transplanted weights, at the
  tolerances of tests/test_torch_port_pretrain.py;
- `python -m spcl_torch.main_pretrain_encoder --device cpu Trainer.mesh=2`
  (both phases, row_sharded) against the same command without a mesh.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu.data import augment as jaug
from spcl_tpu.data import packing as jpacking
from spcl_tpu.data.creator import create_contrastive_loader as jax_contrastive_loader
from spcl_tpu.hooks.infonce import SelfPacedINFONCEHook as JaxSPHook
from spcl_tpu.models.masking import stage_trainable_mask
from spcl_tpu.models.unet import UNet as JaxUNet
from spcl_tpu.parallel import make_mesh, replicate, shard_batch
from spcl_tpu.training.optim import build_optimizer as jax_build_optimizer
from spcl_tpu.training.state import create_train_state
from spcl_tpu.training.steps import build_pretrain_step as jax_build_pretrain_step
from spcl_torch.data.creator import create_contrastive_loader
from spcl_torch.data.packing import synthetic_dataset
from spcl_torch.models import (UNet, head_state_dict_from_flax, stages_from_range,
                               unet_state_dict_from_flax)
from spcl_torch.parallel.mesh import spawn_local
from spcl_torch.training import load_checkpoint, load_model_state_dict

import torch_parallel_workers as workers
from test_torch_port_pretrain import _get, _random_encoder, _random_head
from torch_port_helpers import jax_step_draws

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 300.0
RANKS = 2


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Per-rank {scenario: result} of the 2-rank runs."""
    save_dir = tmp_path_factory.mktemp("mesh")
    return save_dir, spawn_local(RANKS, workers.trainer_worker, (str(save_dir), RANKS),
                                 device="cpu", timeout_s=JOIN_S, collective_timeout_s=120.0)


@pytest.fixture(scope="module")
def single_runs(tmp_path_factory):
    save_dir = tmp_path_factory.mktemp("single")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return save_dir, {
            # off-mesh `row_sharded` is the single-device loss
            "pretrain": workers.run_pretrain(save_dir / "pre", 1, "row_sharded"),
            "finetune": workers.run_finetune(save_dir / "ft", 1)}
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("contrast", ["replicated", "row_sharded"])
def test_mesh_pretrain_matches_single_process(mesh_runs, single_runs, contrast):
    one = single_runs[1]["pretrain"]
    assert one["n_shards"] == 1 and len(one["reg_loss"]) == 4
    for r in range(RANKS):
        got = mesh_runs[1][r][f"pretrain_{contrast}"]
        assert got["n_shards"] == RANKS
        np.testing.assert_allclose(got["reg_loss"], one["reg_loss"], rtol=1e-5)
        np.testing.assert_allclose(got["sp_weight"], one["sp_weight"], rtol=1e-5)
        assert got["age_param"] == one["age_param"]
        np.testing.assert_allclose(got["conv5"], one["conv5"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["running_var"], one["running_var"], rtol=1e-5)


def test_row_sharded_equals_replicated_on_every_rank(mesh_runs):
    ranks = mesh_runs[1]
    for r in range(RANKS):
        rs, rp = ranks[r]["pretrain_row_sharded"], ranks[r]["pretrain_replicated"]
        np.testing.assert_allclose(rs["reg_loss"], rp["reg_loss"], rtol=1e-5)
        np.testing.assert_allclose(rs["sp_weight"], rp["sp_weight"], rtol=1e-5)
        np.testing.assert_allclose(rs["conv5"], rp["conv5"], rtol=1e-4, atol=1e-6)
    for name in ("pretrain_row_sharded", "pretrain_replicated", "finetune"):
        for key in ("reg_loss", "sp_weight", "sup_loss", "conv5", "conv1"):
            if key in ranks[0][name]:  # the replicas never drift apart: equal bits
                np.testing.assert_array_equal(ranks[0][name][key], ranks[1][name][key])


def test_mesh_finetune_matches_single_process(mesh_runs, single_runs):
    one = single_runs[1]["finetune"]
    for r in range(RANKS):
        got = mesh_runs[1][r]["finetune"]
        assert got["n_shards"] == RANKS
        np.testing.assert_allclose(got["sup_loss"], one["sup_loss"], rtol=1e-5)
        np.testing.assert_allclose(got["score"], one["score"], rtol=1e-5)
        for key in ("val/loss/mean", "val/dice/DSC_mean", "tra/sup_dice/DSC_mean"):
            np.testing.assert_allclose(got["history"][key], one["history"][key], rtol=1e-5,
                                       err_msg=key)
        np.testing.assert_allclose(got["conv1"], one["conv1"], rtol=1e-4, atol=1e-6)


def test_mesh_pads_nondivisible_batches(mesh_runs):
    for r in range(RANKS):
        got = mesh_runs[1][r]["finetune_padded"]
        assert 0.0 <= got["score"] <= 1.0
        assert np.isfinite(got["sup_loss"]).all() and len(got["sup_loss"]) == 2
        assert np.isfinite(got["history"]["val/loss/mean"])
        assert np.isfinite(got["conv1"]).all()


def test_pallas_layout_refused_under_mesh(mesh_runs):
    for r in range(RANKS):
        assert "incompatible with Trainer.mesh" in mesh_runs[1][r]["pallas_refused"]


def test_files_written_by_rank_0_only(mesh_runs):
    """Rank 0 writes the checkpoints, storage.csv, the run's config.yaml and
    (where tensorboard imports) one TensorBoard event file, named by time and
    host; the other ranks write nothing."""
    try:
        import tensorboard  # noqa: F401
        events = ["events"]
    except ImportError:
        events = []

    def run_files(files):
        return sorted("events" if f.startswith("events.out.tfevents") else f for f in files)

    ranks = mesh_runs[1]
    for name in ("pretrain_replicated", "pretrain_row_sharded"):
        assert run_files(ranks[0][name]["files"]) == sorted(
            [".success", "config.yaml", "last.ckpt"] + events)
        assert ranks[1][name]["files"] == []
    for name in ("finetune", "finetune_padded"):
        assert run_files(ranks[0][name]["files"]) == sorted(
            [".success", "best.ckpt", "config.yaml", "last.ckpt", "storage.csv"] + events)
        assert ranks[1][name]["files"] == []


def test_mesh_checkpoint_loads_strictly_both_ways(mesh_runs, single_runs):
    """The cross-rank BatchNorm has nn.BatchNorm2d's parameters and buffers:
    a mesh run's checkpoint loads strictly into a single-process model, and a
    single-process checkpoint into the model of a mesh run (the same class
    and keys), for both trainers."""
    for sub, scenario in (("row_sharded", "pre"), ("ft", "ft")):
        mesh_ckpt = mesh_runs[0] / sub / "rank0" / "last.ckpt"
        single_ckpt = single_runs[0] / scenario / "rank0" / "last.ckpt"
        a, b = load_model_state_dict(str(mesh_ckpt)), load_model_state_dict(str(single_ckpt))
        assert list(a) == list(b)
        for sd in (a, b):
            UNet(max_channel=workers.MAXC).load_state_dict(sd, strict=True)
        full = load_checkpoint(str(mesh_ckpt))
        assert full["cur_epoch"] == (2 if scenario == "pre" else 1)
        assert set(full) >= {"_model", "_optimizer", "cur_epoch"}


# ------------------------------------------------------------------ against spcl_tpu
def _flax_paths():
    """(name in the rank's result, flax path, flax -> torch layout) of every
    encoder and head parameter."""
    for name in ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5"):
        for i, (c, b) in enumerate(((0, 1), (3, 4))):
            yield (f"_{name}.conv.{c}.weight", ("model", name, f"conv{i}", "kernel"),
                   lambda w: np.transpose(w, (3, 2, 0, 1)))
            yield f"_{name}.conv.{b}.weight", ("model", name, f"bn{i}", "scale"), lambda w: w
            yield f"_{name}.conv.{b}.bias", ("model", name, f"bn{i}", "bias"), lambda w: w
    for fc in ("fc0", "fc1"):
        yield f"head.{fc}.weight", ("hooks", "sp", "params", fc, "kernel"), lambda w: w.T
        yield f"head.{fc}.bias", ("hooks", "sp", "params", fc, "bias"), lambda w: w


FLIP_SENSITIVE = ("_Conv4.conv.0.weight", "_Conv4.conv.1.bias")


def test_two_rank_pretrain_step_matches_jax_mesh_step():
    """One pretrain step: spcl_tpu under make_mesh(8) (GSPMD, row_sharded
    criterion) and spcl_torch on 2 gloo ranks, from the same weights, global
    batch (24 slices) and draws. Loss and sp_weight rtol 1e-4, updated
    parameters atol 1e-6 at lr 1e-3; the port's summed gradients against
    spcl_tpu's gradients of the global loss: Conv4, Conv5 and the head
    relative L2 2e-4, Conv1-Conv3 2e-2 (ReLU / max-pool routing flips under
    float32 rounding; see tests/test_torch_port_pretrain.py). At 24 slices
    the flips of the Conv3 pool also reach the two Conv4 parameters that see
    its output first (measured 7e-4 and 4e-4, the rest of Conv4 4e-5), so
    these two take the 2e-2 bound; against that, the port's 2-rank gradients
    are held to its own single-process gradients at 1e-4 for every parameter
    (measured at most 1.3e-5)."""
    assert len(jax.devices()) >= 8
    rng = np.random.default_rng(0)
    params, stats = _random_encoder(rng)
    head = _random_head(rng, 128)
    jds = jpacking.synthetic_dataset("acdc", num_scans=8, canvas=40, seed=0)
    jbatch = next(iter(jax_contrastive_loader(jds, scan_sample_num=8, seed=3)))
    pds = synthetic_dataset("acdc", num_scans=8, canvas=40, seed=0)
    pbatch = next(iter(create_contrastive_loader(pds, scan_sample_num=8, seed=3)))
    n = jbatch["image"].shape[0]
    assert n == 24
    gamma, lr, wd = 3.0, 1e-3, 1e-5
    key = jax.random.PRNGKey(42)

    mesh8 = make_mesh(8)
    jpol = dataclasses.replace(jaug.ACDC_PRETRAIN, crop=32)
    jnet = JaxUNet(input_dim=1, num_classes=4, max_channel=128)
    jhook = JaxSPHook(name="sp", feature_name="Conv5", weight=0.1, mode="hard",
                      begin_value=3, end_value=14, max_epoch=2,
                      global_contrast="row_sharded")
    tx = jax_build_optimizer(name="RAdam", lr=lr, weight_decay=wd)
    mask = stage_trainable_mask(params, stages_from_range(None, "Conv5"))
    state = create_train_state(model_params=params, batch_stats=stats,
                               hook_params={"sp": head}, tx=tx)
    scalars = {"sp": {"gamma": jnp.float32(gamma)}}
    jstep = jax_build_pretrain_step(jnet, [jhook], tx, policy=jpol, total_freedom=True,
                                    until="Conv5", grad_mask=mask, mesh=mesh8)
    new_state, jmetrics = jstep(replicate(state, mesh8), shard_batch(jbatch, mesh8),
                                replicate(key, mesh8), scalars)
    jbatch_dev = jax.tree_util.tree_map(jnp.asarray, jbatch)

    def loss_fn(p):  # the step's loss on one device, spelled out for its gradients
        k_aug, k_flip, k_hooks = jax.random.split(key, 3)
        image = jbatch_dev["image"].astype(jnp.float32) / 255.0
        (v1, _), (v2, _) = jaug.augment_twice(k_aug, image, None, jpol, total_freedom=True,
                                              sizes=jbatch_dev["size"])
        fp = jaug.flip_params(k_flip, n, threshold=0.8)
        v2 = jaug.apply_flip(v2, fp)
        acts, _ = jnet.apply({"params": p["model"], "batch_stats": stats},
                             jnp.concatenate([v1, v2]), train=True, until="Conv5",
                             mutable=["batch_stats"])
        ctx = {"acts": acts, "n_unl": n, "flip": fp, "mesh": None, "key": k_hooks,
               **{k: jbatch_dev[k] for k in ("partition", "patient", "cycle", "scan_idx",
                                             "valid")}}
        return jhook.loss_fn(p["hooks"]["sp"], ctx, scalars["sp"])[0]

    jgrads = jax.jit(jax.grad(loss_fn))(state.params)

    draws = jax.tree_util.tree_map(
        lambda t: t.numpy(), jax_step_draws(key, n, jpol, 40, sizes=jbatch_dev["size"]))
    args = (unet_state_dict_from_flax(params, stats, allow_partial=True),
            head_state_dict_from_flax(head), dict(pbatch), draws, gamma, lr, wd, "row_sharded")
    results = spawn_local(RANKS, workers.pretrain_step_worker, args, device="cpu",
                          timeout_s=JOIN_S, collective_timeout_s=120.0)
    single = workers.pretrain_step_worker(*args)  # no process group here: the plain path

    for got in results:
        np.testing.assert_allclose(got["reg_loss"], float(jmetrics["reg_loss"]), rtol=1e-4)
        np.testing.assert_allclose(got["sp_weight"],
                                   float(jmetrics["hooks"]["sp"]["sp_weight"]), rtol=1e-4)
    for k in results[0]["params"]:  # the replicas stay equal, bit for bit
        np.testing.assert_array_equal(results[0]["params"][k], results[1]["params"][k])
        np.testing.assert_array_equal(results[0]["grads"][k], results[1]["grads"][k])
    rels = {}
    for torch_key, path, layout in _flax_paths():
        np.testing.assert_allclose(results[0]["params"][torch_key],
                                   layout(_get(new_state.params, path)), rtol=0, atol=1e-6,
                                   err_msg=torch_key)
        want = layout(_get(jgrads, path))
        rel = np.linalg.norm(results[0]["grads"][torch_key] - want) / np.linalg.norm(want)
        rels[torch_key] = (float(rel), 2e-2 if path[1] in ("Conv1", "Conv2", "Conv3")
                           or torch_key in FLIP_SENSITIVE else 2e-4)
        # ... while 2 ranks and one process of the port agree closely everywhere
        mine = single["grads"][torch_key]
        rel = np.linalg.norm(results[0]["grads"][torch_key] - mine) / np.linalg.norm(mine)
        rels[torch_key + " (2 ranks vs 1)"] = (float(rel), 1e-4)
    assert len(rels) == 2 * (5 * 6 + 4) == 2 * len(results[0]["params"])
    assert all(rel <= tol for rel, tol in rels.values()), \
        " ".join(f"{k}={rel:.1e}/{tol:.0e}" for k, (rel, tol) in rels.items())


def test_entry_point_mesh_matches_single_process(tmp_path):
    """Both phases through `spcl_torch.main_pretrain_encoder.main` on the
    CPU: `Trainer.mesh=2` with the row_sharded criterion against no mesh.
    Batch sizes divide the ranks, so the runs are the same computation:
    the pretrained Conv5 kernel rtol 1e-4, atol 1e-6 and the fine-tuned Conv1
    kernel alike; scores in [0, 1] and equal to 1e-5."""
    from spcl_torch.main_pretrain_encoder import main

    def run(save_dir, *extra):
        return main(["Arch.max_channel=64", "Data.synthetic=true", "Data.canvas=48",
                     "Data.crop=32", "Data.synthetic_scans=6", "Data.ratios=[2]",
                     "Trainer.num_batches=2", "Trainer.max_epoch=1", "LabeledLoader.batch_size=4",
                     f"Trainer.save_dir={save_dir}", "ContrastiveLoaderParams.scan_sample_num=2",
                     "SPInfonceParams.global_contrast=row_sharded", *extra, "--opt-path",
                     str(ROOT / "config" / "specific" / "selfpaced_infonce.yaml")],
                    device="cpu")

    two = run(tmp_path / "mesh", "Trainer.mesh=2")
    one = run(tmp_path / "single")
    assert sorted(two) == sorted(one) == [2]
    assert 0.0 <= two[2] <= 1.0
    np.testing.assert_allclose(two[2], one[2], rtol=1e-5, atol=1e-7)
    for ckpt, key in (("pre/last.ckpt", "_Conv5.conv.0.weight"),
                      ("tra_2/last.ckpt", "_Conv1.conv.0.weight")):
        a = load_model_state_dict(str(tmp_path / "mesh" / ckpt))
        b = load_model_state_dict(str(tmp_path / "single" / ckpt))
        np.testing.assert_allclose(a[key].numpy(), b[key].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=ckpt)
    assert (tmp_path / "mesh" / "tra_2" / "storage.csv").exists()
    assert (tmp_path / "mesh" / "pre" / ".success").exists()
