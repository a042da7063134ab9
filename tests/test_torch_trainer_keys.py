"""The `Trainer` keys of spcl_tpu build in spcl_torch and are wired: the
paper's configuration (base.yaml + pretrain.yaml +
specific/selfpaced_infonce.yaml) builds as it is, with
`Trainer.grad_cache=30` (the trainer's step is then the gradient cache's,
with 30 chunks), with `dump_matrices` (the matrix probe is built), with
`profile_dir` (epoch start + 1 of the loop goes through the profiler) and
with `defer_reads` (`start_training` takes the deferred loop).
`dump_matrices` together with `grad_cache` raises spcl_tpu's ValueError. The
semi and mixup trainers build (`semi` with production_semi.yaml + mt.yaml +
uda.yaml, as `chip_smoke.py` runs it). Under `Trainer.mesh=2` the semi,
mixup, meanteacher, adversarial and decoder-pretrain trainers build and
init in the processes of a 2-rank gloo run (their training under a mesh is
held in tests/test_torch_parallel_semi.py). A decoder-stage InfoNCE hook
with `Trainer.grad_cache` raises NotImplementedError with spcl_tpu's reason
(spcl_tpu/training/gradcache.py:75-79), before any data is loaded. CPU
only."""
from pathlib import Path

import numpy as np
import pytest

from spcl_torch import CONFIG_PATH
from spcl_torch.configure import ConfigManager
from spcl_torch.entry import build_trainer
from spcl_torch.parallel.mesh import spawn_local

import torch_parallel_workers as workers

PAPER = str(Path(CONFIG_PATH) / "specific" / "selfpaced_infonce.yaml")


def _config(*overrides):
    config = ConfigManager(str(Path(CONFIG_PATH) / "base.yaml"),
                           str(Path(CONFIG_PATH) / "pretrain.yaml"), strict=False).parse_args(
        ["Data.synthetic=true", *overrides, "--opt-path", PAPER]).merged_config
    config["Trainer"]["name"] = "pretrain_encoder"
    return config


@pytest.mark.parametrize("override,refused", [
    ("Trainer.grad_cache=30", None),  # bigbatch_pretrain.yaml's chunk count
    ("Trainer.dump_matrices=true", None),
    ("Trainer.profile_dir=runs/prof", None),
    ("Trainer.defer_reads=true", None),
    ("Trainer.device_data=true", None),  # the paper's configuration as base.yaml sets it
])
def test_unported_trainer_keys_are_refused(tmp_path, monkeypatch, override, refused):
    """No key is refused any more (`refused` is None in every case): each
    builds and is wired."""
    from spcl_torch.training import trainer as trainer_mod
    config = _config(override)
    assert refused is None
    trainer = build_trainer(config, save_dir=str(tmp_path), pretrain=True, device="cpu")
    assert trainer._forward_until == "Conv5"
    trainer.init()
    chunks = getattr(trainer._train_step, "num_chunks", None)
    assert chunks == (30 if override == "Trainer.grad_cache=30" else None)
    assert (trainer._matrix_probe is not None) == (override == "Trainer.dump_matrices=true")
    # profile_dir: the loop's dispatch of epoch start + 1 goes through the profiler
    traced = []
    monkeypatch.setattr(trainer_mod.profiling, "trace",
                        lambda run, d: traced.append(d) or run())
    monkeypatch.setattr(trainer, "_dispatch_train_epoch", lambda: {"epoch": "stub"})
    for epoch in (1, 2):
        trainer._cur_epoch = epoch
        assert trainer._dispatch_maybe_profiled(start=1) == {"epoch": "stub"}
    assert traced == (["runs/prof"] if override == "Trainer.profile_dir=runs/prof" else [])
    # defer_reads: start_training takes the deferred loop
    trainer._cur_epoch = 0
    monkeypatch.setattr(trainer, "_start_training_deferred", lambda: "deferred")
    monkeypatch.setattr(trainer, "_dispatch_train_epoch", lambda: 1 / 0)  # eager: fails
    if override == "Trainer.defer_reads=true":
        assert trainer.start_training() == "deferred"
    else:
        with pytest.raises(ZeroDivisionError):
            trainer.start_training()


def test_dump_matrices_with_grad_cache_raises(tmp_path):
    config = _config("Trainer.grad_cache=30", "Trainer.dump_matrices=true")
    with pytest.raises(ValueError, match="incompatible with Trainer.grad_cache"):
        build_trainer(config, save_dir=str(tmp_path), pretrain=True, device="cpu")


def _semi_config(*overrides):
    specific = Path(CONFIG_PATH) / "specific"
    return ConfigManager(str(Path(CONFIG_PATH) / "base.yaml"), strict=False).parse_args(
        ["Data.synthetic=true", *overrides, "--opt-path",
         str(specific / "production_semi.yaml"), str(specific / "mt.yaml"),
         str(specific / "uda.yaml")]).merged_config


@pytest.mark.parametrize("name,hooks", [("semi", ["consistency", "mt"]),
                                        ("mixup", ["mix_reg"])])
def test_semi_and_mixup_trainers_build(tmp_path, name, hooks):
    config = _semi_config(f"Trainer.name={name}")
    if name == "mixup":
        config["MixUpParams"] = {"weight": 0.01, "enable_bn": True}
        del config["MeanTeacherParams"], config["ConsistencyParams"]
    trainer = build_trainer(config, save_dir=str(tmp_path), device="cpu")
    assert type(trainer).__name__ == {"semi": "SemiTrainer", "mixup": "MixUpTrainer"}[name]
    assert [h.name for h in trainer.hooks] == hooks


def _decoder_config(*overrides):
    config = _config(*overrides)
    config["Trainer"]["name"] = "pretrain_decoder"
    del config["SPInfonceParams"]
    config["InfonceParams"] = {"feature_names": "Up_conv3", "weights": 1.0,
                               "contrast_ons": "self"}
    return config


SMALL = ["Data.canvas=48", "Data.crop=32", "Arch.max_channel=32", "Data.synthetic_scans=4",
         "Data.synthetic_test_scans=3"]
MESH_TRAINERS = {
    "semi": ("SemiTrainer", ["consistency", "mt"]),
    "mixup": ("MixUpTrainer", ["mix_reg"]),
    "meanteacher": ("SemiTrainer", ["consistency", "mt"]),
    "adv": ("AdversarialTrainer", []),
    "pretrain_decoder": ("PretrainDecoderTrainer", ["infonce/Up_conv3/self"]),
}


@pytest.fixture(scope="module")
def mesh_built(tmp_path_factory):
    """Every trainer of MESH_TRAINERS built and init'ed under Trainer.mesh=2 in
    the 2 processes of a gloo run."""
    configs = {}
    for name in MESH_TRAINERS:
        if name == "pretrain_decoder":
            configs[name] = _decoder_config("Trainer.mesh=2", *SMALL,
                                            "ContrastiveLoaderParams.scan_sample_num=2")
            continue
        config = _semi_config(f"Trainer.name={name}", "Trainer.mesh=2", *SMALL)
        if name == "mixup":
            config["MixUpParams"] = {"weight": 0.01, "enable_bn": True}
            del config["MeanTeacherParams"], config["ConsistencyParams"]
        configs[name] = config
    return spawn_local(2, workers.build_trainers_worker,
                       (configs, str(tmp_path_factory.mktemp("built"))), device="cpu",
                       timeout_s=300.0, collective_timeout_s=120.0)


@pytest.mark.parametrize("name", list(MESH_TRAINERS))
def test_trainers_build_under_a_mesh(mesh_built, name):
    """Built and init'ed in each rank: the trainer class, its hooks, the EMA
    teacher where a hook needs it, 2 shards, and replicas that start from
    rank 0's weights."""
    kind, hooks = MESH_TRAINERS[name]
    for rank in mesh_built:
        got = rank[name]
        assert got["type"] == kind and got["n_shards"] == 2
        assert sorted(got["hooks"]) == sorted(hooks)
        assert got["teacher"] == ("mt" in hooks)
    np.testing.assert_array_equal(mesh_built[0][name]["conv1"], mesh_built[1][name]["conv1"])


@pytest.mark.parametrize("override,refused", [("Trainer.grad_cache=2", "with Trainer.grad_cache")])
def test_decoder_hooks_under_a_mesh_or_grad_cache_are_refused(tmp_path, override, refused):
    """A decoder hook under a mesh builds (test_trainers_build_under_a_mesh);
    with grad_cache it is refused, as spcl_tpu refuses it."""
    config = _decoder_config(override)
    with pytest.raises(NotImplementedError,
                       match=f"{refused}: grad_cache supports encoder contrastive hooks "
                             r"\(dense point sampling is batch-local"):
        build_trainer(config, save_dir=str(tmp_path), pretrain=True, device="cpu")
