"""The device-resident data path of spcl_torch (`Trainer.device_data`), on
the CPU: `data/device_store.py`, `data/loader.py::device_prefetch`, and the
trainers' epochs over them.

- The store's gather equals `SliceDataset.batch` bit for bit on the root
  dataset, -1 padding included, and spcl_tpu's `gather_from` on the same
  indices (its images NHWC, transposed here).
- On a subset the gather equals the root's rows of `to_global`: the same
  slices and labels; `scan_idx` and `patient` are the root's numbering, a
  one-to-one relabelling of the subset's.
- One store per root dataset and device.
- `device_prefetch` keeps the order and the content of what it is given,
  passes exceptions on, and stops its thread when the consumer stops early.
- A 2-epoch pretrain run and a 1-epoch fine-tune + eval run give the same
  step metrics, Dice and `storage.csv` with `device_data` true and false
  (the same batches, the same draws: equal to the bit).
- `Trainer.packed_eval` gives spcl_tpu's eval statistics (per-scan Dice,
  loss as a mean over chunks) from the same weights (the port's after 40
  fine-tune steps, so that the Dice of two classes is not trivially 0) and
  indices, within rtol 1e-4 (the two UNets' float32 convolutions round
  differently); the per-scan Dice is the same with or without packing.
"""
import csv
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcl_tpu.data import get_data as jax_get_data
from spcl_tpu.data import synthetic_dataset as jax_synthetic_dataset
from spcl_tpu.data.device_store import DeviceStore as JaxDeviceStore
from spcl_tpu.data.device_store import gather_from as jax_gather_from
from spcl_tpu.models.torch_import import flax_from_torch_state_dict
from spcl_tpu.models.unet import UNet as JaxUNet
from spcl_tpu.training.trainer import FineTuneTrainer as JaxFineTuneTrainer
from spcl_torch.data import (DeviceStore, device_prefetch, gather_from, get_data,
                             synthetic_dataset)
from spcl_torch.entry import build_trainer
from spcl_torch.meters import UniversalDice
from spcl_torch.models import UNet
from spcl_torch.training import FineTuneTrainer
from spcl_torch.utils import fix_all_seed

CANVAS, CROP, MAXC = 48, 32, 64
IDX = np.array([3, -1, 0, 17, 17, 9, -1], np.int64)


@pytest.fixture(scope="module")
def root():
    return synthetic_dataset("acdc", num_scans=5, slices_per_scan=(6, 8), canvas=CANVAS,
                             seed=0)


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k].numpy() if torch.is_tensor(got[k]) else np.asarray(got[k])
        assert g.dtype == v.dtype and g.shape == v.shape, (k, g.dtype, v.dtype)
        np.testing.assert_array_equal(g, v, err_msg=k)


def test_gather_equals_host_batch_on_the_root(root):
    store = DeviceStore(root, "cpu")
    _assert_batches_equal(store.gather(torch.from_numpy(IDX)), root.batch(IDX))
    assert store.nbytes() == root.images.nbytes + root.labels.nbytes + 5 * 4 * len(root) + \
        4 * len(root)  # sizes [N, 2] and four meta vectors, int32


def test_gather_on_a_subset_is_the_roots_rows(root):
    sub = root.take(np.arange(len(root))[root.partitions != 1][::2])
    local = np.array([0, 2, -1, 5, 1], np.int64)
    store = DeviceStore.for_dataset(sub, "cpu")
    got = store.gather(torch.from_numpy(sub.to_global(local)))
    _assert_batches_equal(got, root.batch(sub.to_global(local)))
    host = sub.batch(local)
    for k in ("image", "label", "size", "partition", "cycle", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), host[k], err_msg=k)
    keep = local >= 0
    for k in ("scan_idx", "patient"):
        pairs = set(zip(got[k].numpy()[keep].tolist(), host[k][keep].tolist()))
        assert len({a for a, _ in pairs}) == len({b for _, b in pairs}) == len(pairs), k


def test_one_store_per_root_and_device(root):
    sub = root.take([1, 2, 3])
    assert DeviceStore.for_dataset(sub, "cpu") is DeviceStore.for_dataset(root, "cpu")
    other = synthetic_dataset("acdc", num_scans=2, canvas=CANVAS, seed=5)
    assert DeviceStore.for_dataset(other, "cpu") is not DeviceStore.for_dataset(root, "cpu")
    with pytest.raises(ValueError, match="ROOT"):
        DeviceStore(sub, "cpu")


def test_gather_from_equals_spcl_tpu():
    jroot = jax_synthetic_dataset("acdc", num_scans=5, slices_per_scan=(6, 8), canvas=CANVAS,
                                  seed=0)
    proot = synthetic_dataset("acdc", num_scans=5, slices_per_scan=(6, 8), canvas=CANVAS,
                              seed=0)
    want = jax.device_get(jax_gather_from(JaxDeviceStore(jroot).arrays, jnp.asarray(IDX)))
    got = gather_from(DeviceStore(proot, "cpu").arrays, torch.from_numpy(IDX))
    want["image"] = np.transpose(want["image"], (0, 3, 1, 2))
    _assert_batches_equal(got, {k: np.asarray(v) for k, v in want.items()})


def test_device_prefetch_keeps_order_and_content(root):
    rows = [np.array([i, i + 1, -1]) for i in range(9)]
    items = [(root.batch(r), f"extra {i}") for i, r in enumerate(rows)]
    got = list(device_prefetch(iter(items), "cpu", depth=2))
    assert [e for _, e in got] == [e for _, e in items]
    for (batch, _), (host, _) in zip(got, items):
        _assert_batches_equal(batch, host)
    plain = list(device_prefetch((root.batch(r) for r in rows), "cpu"))
    assert len(plain) == len(rows) and isinstance(plain[0], dict)


def test_device_prefetch_raises_and_stops_early(root):
    def failing():
        yield root.batch(IDX)
        raise RuntimeError("the producer fails")

    it = device_prefetch(failing(), "cpu")
    next(it)
    with pytest.raises(RuntimeError, match="the producer fails"):
        next(it)

    def endless():
        while True:
            yield root.batch(IDX)

    before = threading.active_count()
    it = device_prefetch(endless(), "cpu", depth=2)
    next(it)
    it.close()  # the consumer leaves early: the producer thread ends
    assert threading.active_count() == before


# ------------------------------------------------------------------ the trainers
def _config(tmp_path, name, device_data, **trainer):
    return {
        "RandomSeed": 10,
        "Arch": {"input_dim": 1, "num_classes": 4, "max_channel": MAXC, "momentum": 0.1},
        "Optim": {"name": "RAdam", "lr": 1e-3, "weight_decay": 1e-5},
        "Scheduler": {"multiplier": 10, "warmup_max": 2},
        "Data": {"name": "acdc", "labeled_scan_num": 2, "canvas": CANVAS, "crop": CROP,
                 "synthetic": True, "synthetic_scans": 6, "synthetic_test_scans": 4},
        "LabeledLoader": {"batch_size": 4},
        "Trainer": {"num_batches": 2, "name": name, "save_dir": str(tmp_path),
                    "device_data": device_data, **trainer},
        "ContrastiveLoaderParams": {"scan_sample_num": 2, "partition_sample_num": 1},
        "SPInfonceParams": {"feature_names": "Conv5", "weights": 0.1,
                            "contrast_ons": "partition", "temperature": 0.07,
                            "begin_values": 3, "end_values": 14, "p": 0.5, "mode": "soft"},
    }


def _run(tmp_path, name, device_data, **trainer):
    save_dir = tmp_path / f"{name}_{device_data}"
    fix_all_seed(10)  # the UNet's initial weights, as the entry points seed them
    tr = build_trainer(_config(save_dir, name, device_data, **trainer), save_dir=str(save_dir),
                       pretrain=name.startswith("pretrain"), device="cpu")
    tr.init()
    score = tr.start_training()
    return tr, score, save_dir


def test_pretrain_device_data_true_equals_false(tmp_path):
    runs = [_run(tmp_path, "pretrain_encoder", dd, max_epoch=2) for dd in (True, False)]
    (on, _, _), (off, _, _) = runs
    assert on._device_data and not off._device_data
    assert len(on.step_metrics) == 4 and on.step_metrics == off.step_metrics
    for a, b in zip(on.model.state_dict().values(), off.model.state_dict().values()):
        assert torch.equal(a, b)
    thr = on.last_epoch_stats["tra"]["throughput"]
    assert thr["slices_per_sec"] > 0


def test_finetune_and_eval_device_data_true_equals_false(tmp_path, monkeypatch):
    groups = []
    add = UniversalDice._add

    def recording_add(self, inter, union, group_name=None):
        groups.append(group_name)
        return add(self, inter, union, group_name)

    monkeypatch.setattr(UniversalDice, "_add", recording_add)
    runs = [_run(tmp_path, "ft", dd, max_epoch=1) for dd in (True, False)]
    (on, s_on, d_on), (off, s_off, d_off) = runs
    # the train Dice groups by the labeled slices' scan names (2 train steps,
    # then one per val scan), on both paths
    labeled = set(on._labeled_loader.dataset.unique_scans)
    for run in (groups[:len(groups) // 2], groups[len(groups) // 2:]):
        assert all(set(g) <= labeled and len(g) == 4 for g in run[:2]), run[:2]
        assert all(isinstance(g, str) for g in run[2:])
    assert isinstance(on, FineTuneTrainer) and 0.0 <= s_on <= 1.0
    assert s_on == s_off and on.step_metrics == off.step_metrics
    # everything but the measured rates agrees to the bit, also in storage.csv
    hist = [{k: v for k, v in r._storage.history[1].items() if "throughput" not in k}
            for r in (on, off)]
    assert hist[0] == hist[1] and "val/dice/DSC_mean" in hist[0]
    assert "tra/throughput/slices_per_sec" in on._storage.history[1]
    tables = []
    for d in (d_on, d_off):
        header, row = list(csv.reader(open(d / "storage.csv")))
        tables.append({h: v for h, v in zip(header, row) if "throughput" not in h})
    assert tables[0] == tables[1]


# ------------------------------------------------------------------ packed eval
def _eval_pair(tmp_path, packed):
    """The val epoch of spcl_torch's and spcl_tpu's fine-tune trainers from
    the same weights, both with device_data and `packed_eval=packed`."""
    config = {"Optim": {"name": "adam", "lr": 1e-2}, "Trainer": {"packed_eval": packed}}
    kw = dict(labeled_scan_num=2, labeled_batch_size=4, unlabeled_batch_size=4,
              load_predefined_list=False)
    pdata = get_data(tra_set=synthetic_dataset("acdc", num_scans=6, canvas=CANVAS, seed=0),
                     test_set=synthetic_dataset("acdc", num_scans=6, canvas=CANVAS, seed=1,
                                                mode="val"), **kw)
    jdata = jax_get_data(tra_set=jax_synthetic_dataset("acdc", num_scans=6, canvas=CANVAS,
                                                       seed=0),
                         test_set=jax_synthetic_dataset("acdc", num_scans=6, canvas=CANVAS,
                                                        seed=1, mode="val"), **kw)
    assert pdata[2].dataset.filenames == jdata[2].dataset.filenames
    torch.manual_seed(3)
    model = UNet(input_dim=1, num_classes=4, max_channel=128)  # spcl_tpu's least
    with torch.no_grad():  # BatchNorm running statistics away from (0, 1)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.uniform_(-0.1, 0.1)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 2.0)
    ptr = FineTuneTrainer(model=model, labeled_loader=pdata[0], val_loader=pdata[2],
                          test_loader=None, save_dir=str(tmp_path / "p"), max_epoch=1,
                          num_batches=40, config=config, crop=CROP, device="cpu")
    ptr.init()
    ptr._cur_epoch = 1
    ptr._run_train_epoch()  # weights whose Dice is not trivially 0
    jtr = JaxFineTuneTrainer(model=JaxUNet(input_dim=1, num_classes=4, max_channel=128),
                             labeled_loader=jdata[0], unlabeled_loader=None,
                             val_loader=jdata[2], test_loader=None,
                             save_dir=str(tmp_path / "j"), max_epoch=1, num_batches=1,
                             config=config, crop=CROP, device_data=True)
    jtr.init()
    params, stats = flax_from_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    jtr._state = jtr._state.replace(params={**jtr._state.params, "model": params},
                                    batch_stats=stats)
    return ptr._run_eval_epoch(pdata[2])[0], jtr._run_eval_epoch(jdata[2])[0]


@pytest.fixture(scope="module")
def eval_pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("packed")
    return {packed: _eval_pair(d / str(packed), packed) for packed in (0, 8)}


@pytest.mark.parametrize("packed", [0, 8])
def test_eval_statistics_match_spcl_tpu(eval_pairs, packed):
    ours, theirs = eval_pairs[packed]
    np.testing.assert_allclose(ours["loss"]["mean"], theirs["loss"]["mean"], rtol=1e-4)
    assert sorted(ours["dice"]) == sorted(theirs["dice"])
    for k, v in theirs["dice"].items():
        np.testing.assert_allclose(ours["dice"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_packed_eval_keeps_per_scan_dice_and_reweights_the_loss(eval_pairs):
    (scan, _), (packed, _) = eval_pairs[0], eval_pairs[8]
    for k, v in scan["dice"].items():
        np.testing.assert_allclose(packed["dice"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert packed["loss"]["mean"] != scan["loss"]["mean"]  # per chunk, not per scan
