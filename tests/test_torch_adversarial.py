"""The adversarial baseline (`main_adv.py`) in spcl_torch against spcl_tpu,
on the CPU.

- `Discriminator` (NCHW, GroupNorm eps 1e-6) from spcl_tpu's flax
  variables transplanted: the logits on the class softmax and with the image
  channel in front (`dis_consider_image`), atol 1e-5 (float32 4x4
  convolutions summed in another order).
- One adversarial step against spcl_tpu's `build_adversarial_step` (UNet-128,
  crop 32 of a 40 canvas, 3 labeled + 3 unlabeled slices with one padded,
  RAdam at lr 1e-3, the discriminator's Adam at b1 0.5, lr 1e-4): the same
  weights, batches and augmentation draws (`jax_adversarial_draws`).
  `reg_weight` 0.5 with `dis_consider_image`, and `reg_weight` 0. Compared:
  sup_loss, gen_loss and dis_loss (rtol 1e-4); Dice inter / union within 8
  pixels (tests/test_torch_semi_step.py's bound); the student after its
  RAdam step (atol 2e-5, that file's bound); the discriminator's gradients,
  scaled by reg_weight before Adam as spcl_tpu scales them, against the
  gradients spcl_tpu's Adam saw (its first moment / (1 - b1)) within 2e-4
  relative L2 (tests/test_torch_port_pretrain.py's bound near the loss;
  measured 0.7-2.0e-5), and the port's Adam first moment equal to
  (1 - b1) x those gradients; the discriminator's update by its Adam step
  within 1e-2 relative L2. Adam's first step moves a weight by
  lr x g / (|g| + eps), about lr x sign(g): where a gradient element sits at
  its own rounding noise (3x3 sums over 4x4 windows that nearly cancel) the
  two packages' signs differ and that element's update by up to 2 lr, so an
  elementwise bound would hold the rounding of those elements; measured
  3e-3 relative L2 for conv3's 2M weights, 127 of them beyond 2e-6. The
  running statistics after the two forwards (rtol 1e-3, atol 1e-4,
  tests/test_torch_finetune.py's bound). With
  `reg_weight` 0 the unlabeled forward and the discriminator step do not
  run: dis_loss 0, the discriminator unchanged, one statistics update.
- `AdversarialTrainer` through `spcl_torch.main_adv` (base.yaml +
  hooks/adv.yaml at a small size): meters `adv_reg/gen_loss` and
  `adv_reg/dis_loss`, and a run resumed from its epoch-1 `last.ckpt` equal
  to the bit to an uninterrupted one: the student, the discriminator and
  both optimizers' states, epoch 2's step metrics.
- `chip_smoke.py`'s transcription of hooks/adv.yaml (slice G runs without
  pyyaml) equals the file, and its merge with base.yaml is ConfigManager's.
"""
import csv
import dataclasses
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spcl_tpu.data import augment as jaug
from spcl_tpu.data import packing as jpacking
from spcl_tpu.models.discriminator import Discriminator as JaxDiscriminator
from spcl_tpu.training.optim import build_optimizer as jax_build_optimizer
from spcl_tpu.training.state import create_train_state
from spcl_tpu.training.steps import build_adversarial_step as jax_build_adversarial_step
from spcl_torch.data import augment as aug
from spcl_torch.data.packing import synthetic_dataset
from spcl_torch.models import Discriminator, head_state_dict_from_flax
from spcl_torch.training import (Adam, AdversarialTrainer, batch_to_device,
                                 build_adversarial_step, build_optimizer, load_checkpoint)
from test_torch_finetune import _pair
from test_torch_semi_step import _check_running_statistics
from test_torch_semi_trainer import _assert_same
from torch_port_helpers import jax_adversarial_draws, nchw

LR, WD, DISCR_LR = 1e-3, 1e-5, 1e-4
CANVAS, CROP = 40, 32
COUNT_ATOL = 8.0
GRAD_TOL = 2e-4  # relative L2, tests/test_torch_port_pretrain.py's bound near the loss


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread (see tests/test_torch_semi_step.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flax_discriminator(in_ch, seed):
    jd = JaxDiscriminator(base_channels=64)
    variables = jd.init(jax.random.PRNGKey(seed), jnp.zeros((2, CROP, CROP, in_ch)))
    return jd, jax.device_get(variables)


def _port_discriminator(variables, in_ch):
    d = Discriminator(in_ch)
    d.load_state_dict({k: torch.from_numpy(v)
                       for k, v in head_state_dict_from_flax(variables).items()}, strict=True)
    return d


@pytest.mark.parametrize("in_ch", [4, 5], ids=["softmax", "with_image"])
def test_discriminator_matches_spcl_tpu(in_ch):
    jd, variables = _flax_discriminator(in_ch, in_ch)
    x = np.random.default_rng(in_ch).random((3, CROP, CROP, in_ch)).astype(np.float32)
    want = np.asarray(jd.apply(variables, jnp.asarray(x)))
    d = _port_discriminator(variables, in_ch)
    assert d.gn1.eps == 1e-6 and d.gn3.num_groups == 32
    got = d(torch.from_numpy(nchw(x))).detach().numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _batches(n_l, n_u):
    """One (labeled, unlabeled) batch pair as (jax dicts, port dicts); the
    last unlabeled row is padding (valid 0)."""
    jds = jpacking.synthetic_dataset("acdc", num_scans=4, canvas=CANVAS, seed=0)
    pds = synthetic_dataset("acdc", num_scans=4, canvas=CANVAS, seed=0)
    rng = np.random.default_rng(31)
    il = rng.choice(len(pds.images), n_l, replace=False)
    iu = rng.choice(len(pds.images), n_u, replace=False)
    iu[-1] = -1
    return (jds.batch(il), jds.batch(iu)), (pds.batch(il), pds.batch(iu))


def _step_pair(reg_weight, dis_consider_image, n_l=3, n_u=3):
    jnet, params, stats, net = _pair(128, "nhwc", 4)
    in_ch = 4 + (1 if dis_consider_image else 0)
    jd, dvars = _flax_discriminator(in_ch, 9)
    jpol = dataclasses.replace(jaug.ACDC_LABEL, crop=CROP)
    ppol = dataclasses.replace(aug.ACDC_LABEL, crop=CROP)
    tx = jax_build_optimizer(name="RAdam", lr=LR, weight_decay=WD)
    dtx = optax.adam(DISCR_LR, b1=0.5, b2=0.999)
    state = create_train_state(model_params=params, batch_stats=stats, hook_params={}, tx=tx,
                               discr_params=dvars, discr_tx=dtx)
    jstep = jax_build_adversarial_step(jnet, jd, tx, dtx, num_classes=4, policy=jpol,
                                       reg_weight=reg_weight,
                                       dis_consider_image=dis_consider_image)
    d = _port_discriminator(dvars, in_ch)
    d_before = {k: v.clone() for k, v in d.state_dict().items()}
    opt = build_optimizer(list(net.parameters()), lr=LR, weight_decay=WD)
    dopt = Adam(d.parameters(), lr=DISCR_LR, betas=(0.5, 0.999))
    step = build_adversarial_step(net, d, opt, dopt, num_classes=4, policy=ppol,
                                  reg_weight=reg_weight, dis_consider_image=dis_consider_image)
    (jl, ju), (pl, pu) = _batches(n_l, n_u)
    jl = jax.tree_util.tree_map(jnp.asarray, jl)
    ju = jax.tree_util.tree_map(jnp.asarray, ju)
    key = jax.random.PRNGKey(17)
    draws = jax_adversarial_draws(key, n_l, n_u, jpol, CANVAS, jl["size"], ju["size"])
    state, jm = jstep(state, jl, ju, key)
    pm = step(batch_to_device(pl, "cpu"), batch_to_device(pu, "cpu"), None, params=draws)
    return dict(jm=jax.device_get(jm), pm=pm, state=jax.device_get(state), net=net, d=d,
                dopt=dopt, d_before=d_before)


@pytest.fixture(scope="module")
def adv_run():
    return _step_pair(0.5, True)


@pytest.fixture(scope="module")
def no_reg_run():
    return _step_pair(0.0, False)


def _runs(request, which):
    return request.getfixturevalue(f"{which}_run")


@pytest.mark.parametrize("which", ["adv", "no_reg"])
def test_adversarial_step_losses_match_spcl_tpu(request, which):
    run = _runs(request, which)
    jm, pm = run["jm"], run["pm"]
    for k in ("sup_loss", "gen_loss", "dis_loss"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    for k in ("inter", "union"):
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]), rtol=0, atol=COUNT_ATOL)
    if which == "adv":
        assert float(pm["gen_loss"]) > 0 and float(pm["dis_loss"]) > 0
    else:
        assert float(pm["gen_loss"]) == 0 and float(pm["dis_loss"]) == 0


@pytest.mark.parametrize("which", ["adv", "no_reg"])
def test_adversarial_step_student_matches_spcl_tpu(request, which):
    from spcl_torch.models import unet_state_dict_from_flax
    run = _runs(request, which)
    want = unet_state_dict_from_flax(run["state"].params["model"], run["state"].batch_stats)
    got = run["net"].state_dict()
    checked = 0
    for k, v in want.items():
        if "running" in k or "num_batches" in k:
            continue
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=2e-5, err_msg=k)
        checked += 1
    assert checked == len(list(run["net"].parameters()))


@pytest.mark.parametrize("which", ["adv", "no_reg"])
def test_adversarial_step_running_statistics_match_spcl_tpu(request, which):
    run = _runs(request, which)
    _check_running_statistics(run["net"], run["state"].batch_stats)
    counts = {int(m.num_batches_tracked) for m in run["net"].modules()
              if isinstance(m, torch.nn.BatchNorm2d)}
    assert counts == {2 if which == "adv" else 1}  # labeled, then unlabeled forward


@pytest.mark.parametrize("which", ["adv", "no_reg"])
def test_adversarial_step_discriminator_matches_spcl_tpu(request, which):
    run = _runs(request, which)
    want = head_state_dict_from_flax(run["state"].discr_params)
    got = run["d"].state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        before = run["d_before"][k].numpy()
        update, want_update = got[k].numpy() - before, v - before
        if which == "adv":
            rel = np.linalg.norm(update - want_update) / np.linalg.norm(want_update)
            assert rel <= 1e-2, (k, rel)
        else:
            assert not update.any() and not want_update.any(), k
    if which == "no_reg":
        assert all(p.grad is None for p in run["d"].parameters())
        return
    # the gradients each Adam saw, reg_weight's scale included: spcl_tpu's
    # first moment after one step is (1 - b1) g; the port leaves g in .grad
    mu = head_state_dict_from_flax(run["state"].discr_opt_state[0].mu)
    b1 = run["dopt"].param_groups[0]["betas"][0]
    for k, p in run["d"].named_parameters():
        got_g, want_g = p.grad.numpy(), mu[k] / (1 - b1)
        rel = np.linalg.norm(got_g - want_g) / np.linalg.norm(want_g)
        assert rel <= GRAD_TOL, (k, rel)
        np.testing.assert_array_equal(run["dopt"].state[p]["mu"].numpy(),
                                      ((1 - b1) * p.grad).numpy(), err_msg=k)


# ------------------------------------------------------------------ the trainer
SMALL = ["Data.synthetic=true", "Data.canvas=40", "Data.crop=32", "Arch.max_channel=128",
         "Data.synthetic_scans=4", "Data.synthetic_test_scans=4", "Trainer.num_batches=2",
         "LabeledLoader.batch_size=3", "UnlabeledLoader.batch_size=3", "Optim.lr=1e-4",
         "Trainer.reg_weight=0.5", "RandomSeed=3"]


def _adv_trainer(save_dir, max_epoch):
    from spcl_torch import CONFIG_PATH
    from spcl_torch.configure import ConfigManager
    from spcl_torch.entry import build_trainer
    from spcl_torch.main_adv import adv_config
    cm = ConfigManager(str(Path(CONFIG_PATH) / "base.yaml"),
                       str(Path(CONFIG_PATH) / "hooks" / "adv.yaml"),
                       strict=False).parse_args(SMALL + [f"Trainer.max_epoch={max_epoch}"])
    config = adv_config(cm.merged_config)
    config["Trainer"]["save_dir"] = str(save_dir)
    trainer = build_trainer(config, save_dir=str(save_dir), device="cpu")
    trainer.init()
    return trainer


def test_adversarial_trainer_resume_equals_an_uninterrupted_run(tmp_path):
    full = _adv_trainer(tmp_path / "full", 2)
    assert isinstance(full, AdversarialTrainer) and not full.hooks
    save_to = full.save_to

    def keep_each_epoch(name):  # the last.ckpt of every epoch, kept
        save_to(name)
        if name == "last.ckpt":
            shutil.copy(tmp_path / "full" / name, tmp_path / f"epoch{full._cur_epoch}.ckpt")

    full.save_to = keep_each_epoch
    best = full.start_training()
    assert 0.0 <= best <= 1.0 and len(full.step_metrics) == 4
    for rec in full.step_metrics:
        assert all(np.isfinite(rec[k]) for k in ("sup_loss", "gen_loss", "dis_loss"))
        assert rec["gen_loss"] > 0 and rec["dis_loss"] > 0
    rows = list(csv.DictReader(open(tmp_path / "full" / "storage.csv")))
    assert len(rows) == 2
    assert all(np.isfinite(float(rows[-1][f"adv_reg/{k}/mean"])) for k in ("gen_loss",
                                                                           "dis_loss"))

    resumed = _adv_trainer(tmp_path / "resumed", 2)
    resumed.resume_from_path(str(tmp_path / "epoch1.ckpt"))
    assert resumed._cur_epoch == 1
    resumed.start_training()
    assert [r["epoch"] for r in resumed.step_metrics] == [2, 2]
    assert resumed.step_metrics == full.step_metrics[2:]
    a = load_checkpoint(str(tmp_path / "full" / "last.ckpt"))
    b = load_checkpoint(str(tmp_path / "resumed" / "last.ckpt"))
    for key in ("_model", "_optimizer", "_discriminator", "_discr_optimizer", "_generator",
                "_samplers", "cur_epoch", "best_score"):
        _assert_same(a[key], b[key], key)
    assert b["_discr_optimizer"]["state"][0]["step"] == 4
    epoch1 = load_checkpoint(str(tmp_path / "epoch1.ckpt"))
    assert not torch.equal(epoch1["_discriminator"]["fc.weight"],
                           b["_discriminator"]["fc.weight"])


def test_main_adv_entry_point(tmp_path):
    from spcl_torch.main_adv import main
    best = main(SMALL + ["Trainer.max_epoch=1", f"Trainer.save_dir={tmp_path}"], device="cpu")
    assert 0.0 <= best <= 1.0
    state = load_checkpoint(str(tmp_path / "last.ckpt"))
    assert "conv0.weight" in state["_discriminator"]
    assert (tmp_path / "best.ckpt").exists() and (tmp_path / ".success").exists()


def test_chip_smoke_config_transcription_matches_the_file():
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke
    from spcl_torch import CONFIG_PATH
    from spcl_torch.configure import ConfigManager
    from spcl_torch.utils.utils import yaml_load
    name = "hooks/adv.yaml"
    assert chip_smoke.CONFIG_FILES[name] == yaml_load(Path(CONFIG_PATH) / name)
    merged = ConfigManager(*[str(Path(CONFIG_PATH) / f) for f in chip_smoke.ADV_FILES],
                           strict=False).parse_args([]).merged_config
    assert chip_smoke._merged(*chip_smoke.ADV_FILES) == merged
