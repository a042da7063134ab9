"""spcl_torch's host data layer, augmentation, schedules and optimizer against
spcl_tpu's, on the CPU.

- datasets, sampler index streams, splits and contrastive batches: equal
  for the same seeds (images compared after NHWC -> NCHW);
- augmentation with the JAX package's draws injected: atol 1e-5 on bilinear
  pixels (float32 coordinate math in another order), labels exact;
- PScheduler exact; the LR schedule per epoch rtol 2e-6 (the JAX schedule
  runs in float32, the port's in python floats);
- RAdam steps against the optax chain: rtol 1e-5, atol 1e-12.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spcl_tpu import CONFIG_PATH
from spcl_tpu.configure import ConfigManager as JaxConfigManager
from spcl_tpu.data import augment as jaug
from spcl_tpu.data import creator as jcreator
from spcl_tpu.data import packing as jpacking
from spcl_tpu.schedulers.gamma import PScheduler as JaxPScheduler
from spcl_tpu.schedulers.lr import warmup_cosine_epoch_schedule as jax_lr
from spcl_tpu.training.optim import build_optimizer as jax_build_optimizer
from spcl_torch.configure import ConfigManager
from spcl_torch.data import augment as aug
from spcl_torch.data import creator, packing
from spcl_torch.schedulers import PScheduler, warmup_cosine_epoch_schedule
from spcl_torch.training.optim import RAdam
from torch_port_helpers import jax_view_draws, nchw, to_torch

PIX = dict(rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def datasets():
    return (jpacking.synthetic_dataset("acdc", num_scans=6, canvas=48, seed=0),
            packing.synthetic_dataset("acdc", num_scans=6, canvas=48, seed=0))


@pytest.mark.parametrize("gen", ["synthetic_dataset", "synthetic_dataset_hard"])
@pytest.mark.parametrize("name", ["acdc", "prostate"])
def test_synthetic_datasets_identical(gen, name):
    a = getattr(jpacking, gen)(name, num_scans=3, canvas=32, seed=1)
    b = getattr(packing, gen)(name, num_scans=3, canvas=32, seed=1)
    assert a.filenames == b.filenames
    for field in ("images", "labels", "sizes", "partitions", "cycles", "scan_index",
                  "patient_index"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)


def test_contrastive_batches_identical(datasets):
    ja, pa = datasets
    jl = jcreator.create_contrastive_loader(ja, scan_sample_num=3, seed=10)
    pl = creator.create_contrastive_loader(pa, scan_sample_num=3, seed=10)
    for jb, pb, _ in zip(iter(jl), iter(pl), range(4)):
        np.testing.assert_array_equal(pb["image"], nchw(jb["image"]))
        for k in ("label", "size", "scan_idx", "patient", "partition", "cycle", "valid"):
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)


def test_sampler_streams_and_splits_identical(datasets):
    ja, pa = datasets
    jout = jcreator.get_data(tra_set=ja, test_set=ja, labeled_scan_num=1, pretrain=True,
                             load_predefined_list=False)
    pout = creator.get_data(tra_set=pa, test_set=pa, labeled_scan_num=1, pretrain=True,
                            load_predefined_list=False)
    for jl, pl in zip(jout, pout):
        assert jl.dataset.filenames == pl.dataset.filenames
        for ji, pi, _ in zip(iter(jl.sampler), iter(pl.sampler), range(5)):
            np.testing.assert_array_equal(ji, pi)


POLICIES = {
    "acdc_pretrain": (jaug.ACDC_PRETRAIN, aug.ACDC_PRETRAIN),
    "acdc_label": (jaug.ACDC_LABEL, aug.ACDC_LABEL),
    "prostate_pretrain": (jaug.PROSTATE_PRETRAIN, aug.PROSTATE_PRETRAIN),
    "spleen_label": (jaug.SPLEEN_LABEL, aug.SPLEEN_LABEL),
}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_apply_geometric_with_injected_params(policy):
    jpol, ppol = (dataclasses.replace(p, crop=24) for p in POLICIES[policy])
    if isinstance(jpol.resize, int):
        jpol, ppol = (dataclasses.replace(p, resize=24) for p in (jpol, ppol))
    elif jpol.resize is not None:
        jpol, ppol = (dataclasses.replace(p, resize=(24, 24)) for p in (jpol, ppol))
    rng = np.random.default_rng(3)
    img = rng.random((5, 32, 32, 1), dtype=np.float32)
    lab = rng.integers(0, 4, (5, 32, 32)).astype(np.int32)
    sizes = np.asarray([[32, 32], [28, 32], [32, 20], [30, 26], [24, 24]], np.int32)
    geo = jaug.sample_geometric(jax.random.PRNGKey(7), 5, jpol, 32, jnp.asarray(sizes))
    ji, jl = jaug.apply_geometric(jnp.asarray(img), jnp.asarray(lab), geo, jpol.crop,
                                  jpol.rotate_after_crop, backend="gather")
    pi, plab = aug.apply_geometric(torch.from_numpy(nchw(img)), torch.from_numpy(lab),
                                   to_torch(geo), ppol.crop, ppol.rotate_after_crop)
    np.testing.assert_allclose(pi.numpy(), nchw(ji), **PIX)
    # nearest labels: equal except where a coordinate sits within float noise
    # of a half-pixel boundary (none for these draws)
    np.testing.assert_array_equal(plab.numpy(), np.asarray(jl))


def test_jitter_and_augment_twice_with_injected_params():
    rng = np.random.default_rng(4)
    img = rng.random((4, 40, 40, 1), dtype=np.float32)
    pol = dataclasses.replace(jaug.ACDC_PRETRAIN, crop=32)
    key = jax.random.PRNGKey(9)
    (j1, _), (j2, _) = jaug.augment_twice(key, jnp.asarray(img), None, pol,
                                          total_freedom=True)
    draws = jax_view_draws(key, 4, pol, 40)
    (p1, _), (p2, _) = aug.augment_twice(torch.from_numpy(nchw(img)), None,
                                         dataclasses.replace(aug.ACDC_PRETRAIN, crop=32), draws)
    np.testing.assert_allclose(p1.numpy(), nchw(j1), **PIX)
    np.testing.assert_allclose(p2.numpy(), nchw(j2), **PIX)


def test_flip_replay_matches():
    x = np.random.default_rng(5).normal(size=(6, 3, 5, 4)).astype(np.float32)
    fp = jaug.flip_params(jax.random.PRNGKey(1), 6, threshold=0.5)
    ref = jaug.apply_flip(jnp.asarray(x), fp)
    got = aug.apply_flip(torch.from_numpy(nchw(x)), to_torch(fp))
    np.testing.assert_array_equal(got.numpy(), nchw(ref))


def test_pscheduler_per_epoch_matches():
    a = JaxPScheduler(max_epoch=75, begin_value=3, end_value=14, p=0.5)
    b = PScheduler(max_epoch=75, begin_value=3, end_value=14, p=0.5)
    for e in range(-1, 80):
        assert a.get_value(e) == b.get_value(e)
        a.step(), b.step()
        assert a.value == b.value


def test_lr_schedule_per_epoch_matches():
    kw = dict(base_lr=1e-7, multiplier=400, warmup_max=10, max_epoch=75, steps_per_epoch=7)
    ja, pa = jax_lr(**kw), warmup_cosine_epoch_schedule(**kw)
    for epoch in range(80):
        step = epoch * 7
        np.testing.assert_allclose(pa(step), float(ja(step)), rtol=2e-6)
        assert pa(step + 6) == pa(step)  # constant within an epoch
        assert pa(step) == ja.host(step)


@pytest.mark.parametrize("lr", [1e-7, 1e-3])
def test_radam_steps_match_optax_chain(lr):
    """RAdam + L2 weight decay, 8 steps (past the rectification threshold at
    step 6) on the same gradients, against spcl_tpu's optax chain."""
    rng = np.random.default_rng(6)
    params = {"w": rng.normal(size=(5, 7)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32)
              for k, v in params.items()} for _ in range(8)]
    tx = jax_build_optimizer(name="RAdam", lr=lr, weight_decay=1e-5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = RAdam(list(tp.values()), lr=lr, weight_decay=1e-5)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-12, err_msg=k)


def test_config_merge_matches():
    argv = ["Trainer.max_epoch=3", "Data.synthetic=true", "--opt-path",
            str(Path(CONFIG_PATH) / "specific" / "selfpaced_infonce.yaml")]
    paths = (str(Path(CONFIG_PATH) / "base.yaml"), str(Path(CONFIG_PATH) / "pretrain.yaml"))
    a = JaxConfigManager(*paths, strict=False).parse_args(argv).merged_config
    b = ConfigManager(*paths, strict=False).parse_args(argv).merged_config
    assert a == b
