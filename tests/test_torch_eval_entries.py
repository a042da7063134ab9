"""Evaluating and inspecting a trained model with spcl_torch against spcl_tpu,
on the CPU.

- `spcl_torch.meters.surface` against `spcl_tpu.meters.surface` on the cases
  of tests/test_surface_golden.py and on random label maps: equal to the bit
  (the same numpy and scipy calls).
- `spcl_torch.inference` against the root `inference.py` at the TINY config
  of tests/test_inference_entries.py (canvas 64, crop 48, UNet-128, 4 val
  scans), both warm-started from the same random weights (spcl_tpu's warm
  start file, and its transplant for the port), both dumping PNGs. The
  per-slice predictions agree on >= 99.9% of the pixels (an argmax near a tie
  may go the other way: XLA and PyTorch add in other orders); Dice within
  1e-3, HD95 and ASSD within 1 pixel. Fed the same predictions, the two
  packages' meters agree exactly.
- `spcl_torch.val` refuses to run without `Arch.checkpoint`.
- `spcl_torch.weight_inspection` against the root `weight_inspection.py`
  with spcl_tpu's trainer weights transplanted and its view draws injected
  (jax.random.PRNGKey(0), as the script draws them): each gamma's
  sim_logits, pos_mask, sp_mask, loss and kept ratio within 1e-5, and the
  npz keys equal.

spcl_tpu's model runs under `jax.jit` here (`_Jitted`): eagerly, flax
compiles every operation anew for every batch size, which takes minutes;
the jitted function is the same.
"""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import inference as jax_inference
import spcl_tpu.entry as jax_entry
import weight_inspection as jax_inspection
from spcl_tpu.meters import SurfaceMeter as JaxSurfaceMeter
from spcl_tpu.meters import UniversalDice as JaxDice
from spcl_tpu.meters import surface as jax_surface
from spcl_tpu.models.torch_import import write_warm_start
from spcl_torch import CONFIG_PATH, inference, val, weight_inspection
from spcl_torch.configure import ConfigManager
from spcl_torch.entry import build_trainer
from spcl_torch.meters import surface
from spcl_torch.models import head_state_dict_from_flax, unet_state_dict_from_flax
from spcl_torch.training import save_checkpoint
from test_surface_golden import CASES
from test_torch_port_model import random_flax_unet
from torch_port_helpers import jax_view_draws

TINY = [
    "Data.synthetic=true", "Data.canvas=64", "Data.crop=48",
    "Data.synthetic_scans=8", "Data.synthetic_test_scans=4",
    "Arch.max_channel=128", "Trainer.max_epoch=1", "Trainer.num_batches=2",
    "Optim.lr=1e-4", "Scheduler.multiplier=10", "Scheduler.warmup_max=1",
    "LabeledLoader.batch_size=3", "UnlabeledLoader.batch_size=3",
    "Data.labeled_scan_num=2",
]
PIXEL_AGREE = 0.999
DICE_TOL = 1e-3
SURFACE_TOL = 1.0  # pixels
INSPECT_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread (see tests/test_torch_semi_hooks.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Jitted:
    """spcl_tpu's UNet with `init` and `apply` under jax.jit."""

    def __init__(self, model):
        self._model = model
        self.init = jax.jit(model.init, static_argnames=("train", "until"))
        self.apply = jax.jit(model.apply, static_argnames=("train", "until"))

    def __getattr__(self, name):
        return getattr(self._model, name)


def _jitted_build_trainer(build, record=None):
    def wrapped(*args, **kwargs):
        trainer = build(*args, **kwargs)
        trainer._model = _Jitted(trainer._model)
        if record is not None:
            record.append(trainer)
        return trainer
    return wrapped


# ------------------------------------------------------------------ surface metrics
@pytest.mark.parametrize("idx", range(len(CASES)))
def test_surface_distances_equal_spcl_tpu(idx):
    a, b, sp = CASES[idx]
    np.testing.assert_array_equal(surface._surface_distances(a, b, sp),
                                  jax_surface._surface_distances(a, b, sp))
    for pct in (100.0, 95.0):
        assert (surface.hausdorff_distance(a, b, sp, percentile=pct)
                == jax_surface.hausdorff_distance(a, b, sp, percentile=pct))
    assert (surface.average_surface_distance(a, b, sp)
            == jax_surface.average_surface_distance(a, b, sp))


@pytest.mark.parametrize("metername", ["hausdorff", "hausdorff95", "average_surface"])
def test_surface_meter_equals_spcl_tpu_on_random_maps(metername):
    rng = np.random.default_rng(3)
    got = surface.SurfaceMeter(4, report_axises=[1, 2, 3], metername=metername)
    want = JaxSurfaceMeter(4, report_axises=[1, 2, 3], metername=metername)
    for scan in range(4):
        pred = rng.integers(0, 4, (5, 20, 22))
        target = np.where(rng.random((5, 20, 22)) < 0.8, pred, rng.integers(0, 4, (5, 20, 22)))
        if scan == 3:
            pred[pred == 2] = 0  # a class absent from the prediction: NaN, skipped
        spacing = None if scan % 2 else (3.0, 1.25, 1.25)
        got.add(pred, target, group_name=f"s{scan}", voxelspacing=spacing)
        want.add(pred, target, group_name=f"s{scan}", voxelspacing=spacing)
    g, w = got.summary(), want.summary()
    assert list(g) == list(w)
    np.testing.assert_array_equal(np.array(list(g.values())), np.array(list(w.values())))


def test_surface_empty_mask_is_nan():
    a, b = np.zeros((8, 8, 8), bool), np.ones((8, 8, 8), bool)
    assert np.isnan(surface.hausdorff_distance(a, b))
    assert np.isnan(surface.average_surface_distance(a, b))


# ------------------------------------------------------------------ inference
@pytest.fixture(scope="module")
def inference_runs(tmp_path_factory, monkeypatch_module):
    """Both packages' inference entry points from the same random weights,
    with PNG dumps: {"jax" / "port": (report, {png name: pred})}."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("inference")
    params, stats = random_flax_unet(np.random.default_rng(0), max_channel=128)
    write_warm_start(str(tmp / "jax.ckpt"), params, stats)
    save_checkpoint(str(tmp / "port.ckpt"), {"_model": {
        k: torch.from_numpy(v) for k, v in unet_state_dict_from_flax(params, stats).items()}})
    monkeypatch_module.setattr(jax_inference, "build_trainer",
                               _jitted_build_trainer(jax_inference.build_trainer))
    out = {}
    for name, entry, kwargs in (("jax", jax_inference.main, {}),
                                ("port", inference.main, {"device": "cpu"})):
        run = tmp / name
        report = entry(TINY + [f"Arch.checkpoint={tmp}/{name}.ckpt",
                               f"Trainer.save_dir={run}", "Trainer.dump_png=true"], **kwargs)
        preds = {p.name: np.asarray(Image.open(p)) for p in sorted((run / "pred").glob("*.png"))}
        out[name] = (report, preds)
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_inference_predictions_match_spcl_tpu(inference_runs):
    (_, jpreds), (_, preds) = inference_runs["jax"], inference_runs["port"]
    assert list(preds) == list(jpreds) and len(preds) > 4
    agree = sum(int((preds[k] == jpreds[k]).sum()) for k in preds)
    total = sum(p.size for p in preds.values())
    assert agree / total >= PIXEL_AGREE, agree / total
    assert len({int(c) for p in preds.values() for c in np.unique(p)}) > 1


def test_inference_report_matches_spcl_tpu(inference_runs):
    (jreport, _), (report, _) = inference_runs["jax"], inference_runs["port"]
    assert list(report) == list(jreport)
    for k, want in jreport.items():
        tol = DICE_TOL if k.startswith("DSC") else SURFACE_TOL
        if np.isnan(want):
            assert np.isnan(report[k]), k
        else:
            assert abs(report[k] - want) <= tol, (k, report[k], want)


def test_inference_meters_equal_spcl_tpu_on_the_same_predictions(inference_runs):
    """The port's predictions through both packages' meters: equal."""
    _, preds = inference_runs["port"]
    scans = {}
    for name, pred in preds.items():
        scans.setdefault(name.rsplit("_", 1)[0], []).append(pred)
    rng = np.random.default_rng(1)
    triples = []
    for scan, slices in scans.items():
        pred = np.stack(slices).astype(np.int64)
        lab = np.where(rng.random(pred.shape) < 0.9, pred, rng.integers(0, 4, pred.shape))
        triples.append((scan, pred, lab))
    got = inference.score(triples, 4)
    axes = [1, 2, 3]
    jd = JaxDice(4, report_axises=axes)
    jh = JaxSurfaceMeter(4, report_axises=axes, metername="hausdorff95")
    ja = JaxSurfaceMeter(4, report_axises=axes, metername="average_surface")
    for scan, pred, lab in triples:
        jd.add_labels(pred, lab, group_name=scan)
        jh.add(pred, lab, group_name=scan)
        ja.add(pred, lab, group_name=scan)
    want = {**jd.summary(), **jh.summary(), **ja.summary()}
    assert list(got) == list(want)
    np.testing.assert_array_equal(np.array(list(got.values())), np.array(list(want.values())))


def test_val_cli_refuses_without_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="Arch.checkpoint"):
        val.main(TINY + [f"Trainer.save_dir={tmp_path}"], device="cpu")


# ------------------------------------------------------------------ weight inspection
def test_weight_inspection_matches_spcl_tpu(tmp_path, monkeypatch):
    argv = TINY + ["ContrastiveLoaderParams.scan_sample_num=3"]
    hook_yaml = ["--opt-path", "config/hooks/spinfonce.yaml"]  # last: it takes the rest
    trainers = []
    monkeypatch.setattr(jax_entry, "build_trainer",
                        _jitted_build_trainer(jax_entry.build_trainer, trainers))
    want = jax_inspection.main(argv + [f"Trainer.save_dir={tmp_path}/jax"] + hook_yaml)
    (jtrainer,) = trainers
    jhook = [h for h in jtrainer._hooks if h.feature_name][0]

    config = ConfigManager(str(Path(CONFIG_PATH) / "base.yaml"),
                           str(Path(CONFIG_PATH) / "pretrain.yaml"),
                           strict=False).parse_args(argv + hook_yaml).merged_config
    trainer = build_trainer(config, save_dir=str(tmp_path / "port"), pretrain=True, device="cpu")
    trainer.init()
    sd = unet_state_dict_from_flax(jtrainer.state.params["model"], jtrainer.state.batch_stats,
                                   allow_partial=True)
    trainer.model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    hook = [h for h in trainer.hooks if h.feature_name][0]
    assert hook.name == jhook.name
    hook.projector.load_state_dict({k: torch.from_numpy(v) for k, v in head_state_dict_from_flax(
        jtrainer.state.params["hooks"][jhook.name]).items()}, strict=True)
    # the views of the script's first contrastive batch (2n rows of z)
    n = want["gamma_1.0"]["sim_logits"].shape[0] // 2
    draws = jax_view_draws(jax.random.PRNGKey(0), n, jtrainer.train_policy,
                           jtrainer._contrastive_loader.dataset.images.shape[1])
    got = weight_inspection.inspect_trainer(trainer, str(tmp_path / "port"), draws=draws)

    assert list(got) == list(want) == [f"gamma_{g}" for g in weight_inspection.GAMMAS]
    for g, w in want.items():
        for k in ("loss", "downgrade_ratio", "sim_logits", "pos_mask", "sp_mask"):
            np.testing.assert_allclose(got[g][k], w[k], rtol=0, atol=INSPECT_TOL,
                                       err_msg=f"{g}/{k}")
    with np.load(tmp_path / "port" / "weight_inspection.npz") as f, \
            np.load(tmp_path / "jax" / "weight_inspection.npz") as jf:
        assert sorted(f.files) == sorted(jf.files)
        for k in f.files:
            g, m = k.split("/")
            np.testing.assert_array_equal(f[k], got[g][m])
