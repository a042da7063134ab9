"""The trainer features of spcl_torch that spcl_tpu's trainer has, on the CPU:

- the TensorBoard writer writes the tags and values of spcl_tpu's
  `SummaryWriter` for the same meter dict (NaN and non-numbers skipped), and
  the same matrix image, read back with tensorboard's event reader (these
  cases skip only where tensorboard does not import); every trainer writes
  its epochs there;
- `config.yaml` (with the git hash) loads to the dict spcl_tpu's
  `yaml_write` writes, with pyyaml and without it (JSON then);
- `build_matrix_probe` gives spcl_tpu's matrices for the same weights and
  draws (UNet-128 to Conv5, eval mode; rtol 1e-4 on the logits, their exp
  and the soft self-paced weights, the positive mask equal);
- `Trainer.defer_reads` equals the eager loop: storage rows (but the
  wall-clock rates), `best.ckpt` and `last.ckpt` to the bit, the best score
  the same (and the device's float32 score within float32 rounding of it);
  also with `flush_every`, for the pretrain trainer, and resumed at
  `max_epoch`;
- `Trainer.profile_dir` writes a chrome trace that holds the steps' spans,
  whose device time is None on the CPU.
"""
import copy
import csv
import json
import sys

import numpy as np
import pytest
import torch

from spcl_torch.entry import build_trainer
from spcl_torch.training import load_checkpoint
from spcl_torch.utils import profiling
from spcl_torch.utils.utils import fix_all_seed, yaml_write
from spcl_torch.writer import NullWriter, SummaryWriter

CANVAS, CROP, MAXC = 40, 32, 128
STATS = {"tra": {"sup_loss": {"mean": 0.5, "std": float("nan")}, "lr": {"mean": 1e-3},
                 "sup_dice": {"DSC1": 0.25, "DSC_mean": np.float32(0.125)},
                 "throughput": {"slices_per_sec": 120.0}, "name": "not a number"},
         "val": {"dice": {"DSC_mean": 0.75}}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread (see tests/test_torch_semi_step.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _events(log_dir):
    """{scalar tag: [(step, value)]}, {image tag: [encoded image]} of a run
    directory, through tensorboard's own reader."""
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    acc = EventAccumulator(str(log_dir), size_guidance={"scalars": 0, "images": 0})
    acc.Reload()
    scalars = {t: [(e.step, e.value) for e in acc.Scalars(t)] for t in acc.Tags()["scalars"]}
    images = {t: [e.encoded_image_string for e in acc.Images(t)] for t in acc.Tags()["images"]}
    return scalars, images


# ------------------------------------------------------------------ writer
def test_writer_writes_spcl_tpus_tags_and_values(tmp_path):
    pytest.importorskip("tensorboard")
    from spcl_tpu.writer import SummaryWriter as JaxWriter
    matrix = np.arange(16, dtype=np.float32).reshape(4, 4) - 3.0
    for cls, d in ((SummaryWriter, tmp_path / "port"), (JaxWriter, tmp_path / "jax")):
        w = cls(log_dir=str(d))
        w.add_scalars_from_meter_interface(3, **STATS)
        w.add_matrix_image("hook/sim_logits", matrix, 3)
        w.flush()
        w.close()
    port, jax_ = _events(tmp_path / "port"), _events(tmp_path / "jax")
    assert port == jax_
    assert sorted(port[0]) == ["tra/lr/mean", "tra/sup_dice/DSC1", "tra/sup_dice/DSC_mean",
                               "tra/sup_loss/mean", "tra/throughput/slices_per_sec",
                               "val/dice/DSC_mean"]
    assert port[0]["tra/sup_dice/DSC_mean"] == [(3, 0.125)]
    assert list(port[1]) == ["hook/sim_logits"]


def test_null_writer_writes_nothing(tmp_path):
    w = NullWriter()
    w.add_scalars_from_meter_interface(1, **STATS)
    w.add_matrix_image("m", np.eye(3), 1)
    w.flush()
    assert w._tb is None and list(tmp_path.iterdir()) == []


# ------------------------------------------------------------------ config.yaml
CONFIG = {"Arch": {"max_channel": 256, "dtype": "bfloat16", "checkpoint": None},
          "Optim": {"lr": np.float32(1e-3), "betas": (0.9, 0.999)},
          "Data": {"ratios": [1, 2], "sizes": np.arange(3), "n": np.int64(5)},
          "githash": "0123abc"}


@pytest.mark.parametrize("pyyaml", [True, False], ids=["pyyaml", "json"])
def test_config_yaml_loads_to_spcl_tpus_dict(tmp_path, monkeypatch, pyyaml):
    yaml = pytest.importorskip("yaml")
    from spcl_tpu.utils.utils import yaml_write as jax_yaml_write
    jax_yaml_write(CONFIG, tmp_path, "jax.yaml")
    if not pyyaml:
        monkeypatch.setitem(sys.modules, "yaml", None)  # `import yaml` fails
    yaml_write(CONFIG, tmp_path, "config.yaml")
    text = (tmp_path / "config.yaml").read_text()
    if not pyyaml:
        json.loads(text)  # the JSON form
    assert yaml.safe_load(text) == yaml.safe_load((tmp_path / "jax.yaml").read_text())


def test_trainer_writes_config_yaml_with_the_githash(tmp_path):
    yaml = pytest.importorskip("yaml")
    config = _config("ft", max_epoch=1)
    build_trainer(config, save_dir=str(tmp_path), device="cpu")
    written = yaml.safe_load((tmp_path / "config.yaml").read_text())
    assert "githash" in written
    del written["githash"]
    assert written == json.loads(json.dumps(config))


# ------------------------------------------------------------------ the matrix probe
def test_matrix_probe_matches_spcl_tpu():
    import dataclasses

    import jax
    import jax.numpy as jnp

    from spcl_tpu.data import augment as jaug
    from spcl_tpu.data import packing as jpacking
    from spcl_tpu.data.creator import create_contrastive_loader as jax_loader
    from spcl_tpu.hooks.infonce import SelfPacedINFONCEHook as JaxSPHook
    from spcl_tpu.models.unet import UNet as JaxUNet
    from spcl_tpu.training.steps import build_matrix_probe as jax_probe
    from spcl_torch.data import augment as aug
    from spcl_torch.data.creator import create_contrastive_loader
    from spcl_torch.data.packing import synthetic_dataset
    from spcl_torch.hooks import SelfPacedINFONCEHook
    from spcl_torch.models import UNet, head_state_dict_from_flax, unet_state_dict_from_flax
    from spcl_torch.training import batch_to_device, build_matrix_probe
    from test_torch_port_pretrain import _random_encoder, _random_head
    from torch_port_helpers import jax_step_draws

    rng = np.random.default_rng(0)
    params, stats = _random_encoder(rng)
    head = _random_head(rng, MAXC)
    jds = jpacking.synthetic_dataset("acdc", num_scans=4, canvas=CANVAS, seed=0)
    jbatch = jax.tree_util.tree_map(jnp.asarray,
                                    next(iter(jax_loader(jds, scan_sample_num=2, seed=3))))
    pds = synthetic_dataset("acdc", num_scans=4, canvas=CANVAS, seed=0)
    pbatch = next(iter(create_contrastive_loader(pds, scan_sample_num=2, seed=3)))
    n, key, scalars = jbatch["image"].shape[0], jax.random.PRNGKey(7), {"sp": {"gamma": 3.0}}
    jpol = dataclasses.replace(jaug.ACDC_PRETRAIN, crop=CROP)
    kw = dict(name="sp", feature_name="Conv5", weight=0.1, mode="soft", begin_value=3,
              end_value=14, max_epoch=2)
    probe = jax_probe(JaxUNet(input_dim=1, num_classes=4, max_channel=MAXC), [JaxSPHook(**kw)],
                      policy=jpol, total_freedom=True, until="Conv5")
    want = probe({"model": params, "hooks": {"sp": head}}, stats, jbatch, key,
                 {"sp": {"gamma": jnp.float32(3.0)}})["sp"]

    net = UNet(input_dim=1, num_classes=4, max_channel=MAXC)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         unet_state_dict_from_flax(params, stats, allow_partial=True).items()},
                        strict=False)
    hook = SelfPacedINFONCEHook(**kw)
    hook.build(net, "cpu")
    hook.projector.load_state_dict({k: torch.from_numpy(v)
                                    for k, v in head_state_dict_from_flax(head).items()})
    net.train()
    before = copy.deepcopy(net.state_dict())
    got = build_matrix_probe(net, [hook], policy=dataclasses.replace(aug.ACDC_PRETRAIN,
                                                                     crop=CROP),
                             total_freedom=True, until="Conv5")(
        batch_to_device(pbatch, "cpu"), None, scalars,
        params=jax_step_draws(key, n, jpol, CANVAS, sizes=jbatch["size"]))["sp"]
    assert net.training  # the probe's eval mode does not stay
    assert all(torch.equal(a, b) for a, b in zip(before.values(), net.state_dict().values()))
    assert set(got) == set(want) == {"sim_logits", "sim_exp", "pos_mask", "sp_mask"}
    for name in ("sim_logits", "sim_exp", "sp_mask"):  # soft self-paced weights
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got["pos_mask"].numpy(), np.asarray(want["pos_mask"]))


# ------------------------------------------------------------------ defer_reads
def _config(name, **trainer):
    return {
        "RandomSeed": 10,
        "Arch": {"input_dim": 1, "num_classes": 4, "max_channel": MAXC, "momentum": 0.1},
        "Optim": {"name": "RAdam", "lr": 1e-2, "weight_decay": 1e-5},
        "Scheduler": {"multiplier": 10, "warmup_max": 2},
        "Data": {"name": "acdc", "labeled_scan_num": 2, "canvas": CANVAS, "crop": CROP,
                 "synthetic": True, "synthetic_scans": 6, "synthetic_test_scans": 4},
        "LabeledLoader": {"batch_size": 4},
        "Trainer": {"num_batches": 2, "name": name, "device_data": True, **trainer},
        "ContrastiveLoaderParams": {"scan_sample_num": 2, "partition_sample_num": 1},
        "SPInfonceParams": {"feature_names": "Conv5", "weights": 0.1,
                            "contrast_ons": "partition", "temperature": 0.07,
                            "begin_values": 3, "end_values": 14, "p": 0.5, "mode": "soft"},
    }


def _run(save_dir, name, resume=None, **trainer):
    fix_all_seed(10)  # the UNet's initial weights, as the entry points seed them
    tr = build_trainer(_config(name, **trainer), save_dir=str(save_dir),
                       pretrain=name.startswith("pretrain"), device="cpu")
    tr.init()
    if resume is not None:
        tr.resume_from_path(str(resume))
    return tr, tr.start_training()


def _without_rates(tree):
    """A checkpoint or storage tree without the wall-clock rates."""
    if isinstance(tree, dict):
        return {k: _without_rates(v) for k, v in tree.items() if "throughput" not in str(k)}
    if isinstance(tree, (list, tuple)):
        return [_without_rates(v) for v in tree]
    return tree


def _assert_bit_equal(a, b, path="ckpt"):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_bit_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bit_equal(x, y, f"{path}/{i}")
    else:
        assert a == b or (a != a and b != b), (path, a, b)


def _same_checkpoint(d_eager, d_deferred, name):
    _assert_bit_equal(_without_rates(load_checkpoint(str(d_eager / name))),
                      _without_rates(load_checkpoint(str(d_deferred / name))), name)


def _rows(d):
    return [{k: v for k, v in row.items() if "throughput" not in k}
            for row in csv.DictReader(open(d / "storage.csv"))]


@pytest.fixture(scope="module")
def finetune_runs(tmp_path_factory):
    """The fine-tune trainer for 3 epochs: eager, deferred, and deferred with
    flush_every 1 (each flush's last.ckpt recorded)."""
    from spcl_torch.training import trainer as trainer_mod
    d = tmp_path_factory.mktemp("defer")
    eager = _run(d / "eager", "ft", max_epoch=3)
    deferred = _run(d / "deferred", "ft", max_epoch=3, defer_reads=True)
    flushes = []
    save = trainer_mod.save_checkpoint

    def recording_save(path, state):
        flushes.append((path, copy.deepcopy(_without_rates(state))))
        return save(path, state)

    trainer_mod.save_checkpoint = recording_save
    try:
        flushed = _run(d / "flushed", "ft", max_epoch=3, defer_reads=True, flush_every=1)
    finally:
        trainer_mod.save_checkpoint = save
    return dict(d=d, eager=eager, deferred=deferred, flushed=flushed, flushes=flushes)


def test_deferred_finetune_equals_eager(finetune_runs):
    r = finetune_runs
    (eager, s_eager), (deferred, s_deferred) = r["eager"], r["deferred"]
    assert not eager._defer_reads and deferred._defer_reads
    assert 0.0 <= s_eager <= 1.0 and s_deferred == s_eager
    assert np.float32(deferred.device_best_score) == pytest.approx(s_eager, rel=1e-6)
    rows = _rows(r["d"] / "eager")
    assert len(rows) == 3 and _rows(r["d"] / "deferred") == rows
    assert eager.step_metrics == deferred.step_metrics
    for name in ("best.ckpt", "last.ckpt"):
        _same_checkpoint(r["d"] / "eager", r["d"] / "deferred", name)
    assert (r["d"] / "deferred" / ".success").exists()


def test_deferred_flush_every_writes_the_eager_checkpoints(finetune_runs):
    r = finetune_runs
    for name in ("best.ckpt", "last.ckpt"):
        _same_checkpoint(r["d"] / "eager", r["d"] / "flushed", name)
    lasts = [state for path, state in r["flushes"] if path.endswith("last.ckpt")]
    # a flush after epochs 1 and 2, then the end of the run
    assert [s["cur_epoch"] for s in lasts] == [1, 2, 3]
    assert [sorted(s["storage"]["history"]) for s in lasts] == [[1], [1, 2], [1, 2, 3]]
    eager_rows = _without_rates(r["eager"][0]._storage.history)
    for s in lasts:
        assert s["storage"]["history"] == {e: eager_rows[e] for e in s["storage"]["history"]}


def test_deferred_resume_at_max_epoch_keeps_the_state(finetune_runs, tmp_path):
    r = finetune_runs
    tr, score = _run(tmp_path, "ft", resume=r["d"] / "eager" / "last.ckpt", max_epoch=3,
                     defer_reads=True)
    assert score == r["eager"][1] and tr._cur_epoch == 3
    _same_checkpoint(r["d"] / "eager", tmp_path, "last.ckpt")
    assert not (tmp_path / "best.ckpt").exists()


def test_deferred_pretrain_equals_eager(tmp_path):
    (eager, _), (deferred, _) = (_run(tmp_path / mode, "pretrain_encoder", max_epoch=2,
                                      defer_reads=mode == "deferred", flush_every=1)
                                 for mode in ("eager", "deferred"))
    assert len(eager.step_metrics) == 4 and eager.step_metrics == deferred.step_metrics
    _same_checkpoint(tmp_path / "eager", tmp_path / "deferred", "last.ckpt")


def test_deferred_reads_need_device_data(tmp_path):
    with pytest.raises(ValueError, match="requires Trainer.device_data"):
        _run(tmp_path, "ft", max_epoch=1, defer_reads=True, device_data=False)


def test_every_trainer_writes_its_epochs_to_tensorboard(finetune_runs):
    scalars, _ = _events(finetune_runs["d"] / "eager")
    for tag in ("tra/sup_loss/mean", "val/dice/DSC_mean", "val/loss/mean"):
        assert [step for step, _ in scalars[tag]] == [1, 2, 3], tag
    rows = _rows(finetune_runs["d"] / "eager")
    assert [v for _, v in scalars["tra/sup_loss/mean"]] == pytest.approx(
        [float(row["tra/sup_loss/mean"]) for row in rows], rel=1e-6)
    assert _events(finetune_runs["d"] / "deferred")[0].keys() == scalars.keys()


# ------------------------------------------------------------------ profile_dir
def test_profile_dir_writes_a_trace_without_device_time_on_the_cpu(tmp_path):
    prof = tmp_path / "prof"
    tr, _ = _run(tmp_path / "run", "pretrain_encoder", max_epoch=2, profile_dir=str(prof),
                 dump_matrices=True)
    assert (prof / "trace.json").exists()
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert profiling.device_ms_per_step(str(prof), calls=2) is None
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert spans.count("spcl.step") == 2 and tr.profile_ms is None
    # dump_matrices on the same run: batch 0's matrices, also as images
    mats = tr.last_matrices["spinfonce/Conv5/partition"]
    assert {k: v.shape for k, v in mats.items()} == {k: (12, 12) for k in
                                                     ("sim_logits", "sim_exp", "pos_mask",
                                                      "sp_mask")}
    _, images = _events(tmp_path / "run")
    assert sorted(images) == [f"spinfonce/Conv5/partition/{k}" for k in
                              ("pos_mask", "sim_exp", "sim_logits", "sp_mask")]
