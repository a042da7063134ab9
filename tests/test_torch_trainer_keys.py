"""The `Trainer` keys of spcl_tpu build in spcl_torch and are wired: the
paper's configuration (base.yaml + pretrain.yaml +
specific/selfpaced_infonce.yaml) builds as it is, with
`Trainer.grad_cache=30` (the trainer's step is then the gradient cache's,
with 30 chunks), with `dump_matrices` (the matrix probe is built), with
`profile_dir` (epoch start + 1 of the loop goes through the profiler) and
with `defer_reads` (`start_training` takes the deferred loop).
`dump_matrices` together with `grad_cache` raises spcl_tpu's ValueError. The
semi and mixup trainers build (`semi` with production_semi.yaml + mt.yaml +
uda.yaml, as `chip_smoke.py` runs it); `Trainer.mesh` with either, or with
the adversarial trainer, raises NotImplementedError until ROADMAP A12
(rest), and so does a decoder-stage InfoNCE hook under a mesh or with
`Trainer.grad_cache`. CPU only; the refused cases raise before any data is
loaded."""
from pathlib import Path

import pytest

from spcl_torch import CONFIG_PATH
from spcl_torch.configure import ConfigManager
from spcl_torch.entry import build_trainer

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


@pytest.mark.parametrize("name", ["semi", "mixup", "meanteacher"])
def test_semi_trainers_under_a_mesh_are_refused(tmp_path, name):
    config = _semi_config(f"Trainer.name={name}", "Trainer.mesh=2")
    with pytest.raises(NotImplementedError, match="ROADMAP A12 rest"):
        build_trainer(config, save_dir=str(tmp_path), device="cpu")


def test_adversarial_trainer_is_refused(tmp_path):
    """Under a mesh: the adversarial trainer itself builds since it was
    ported (tests/test_torch_adversarial.py)."""
    config = _semi_config("Trainer.name=adv", "Trainer.mesh=2")
    with pytest.raises(NotImplementedError, match="adv trainer is not ported yet "
                                                  r"\(ROADMAP A12 rest\)"):
        build_trainer(config, save_dir=str(tmp_path), device="cpu")


@pytest.mark.parametrize("override,refused", [("Trainer.mesh=2", "under Trainer.mesh"),
                                              ("Trainer.grad_cache=2", "with Trainer.grad_cache")])
def test_decoder_hooks_under_a_mesh_or_grad_cache_are_refused(tmp_path, override, refused):
    config = _config(override)
    config["Trainer"]["name"] = "pretrain_decoder"
    del config["SPInfonceParams"]
    config["InfonceParams"] = {"feature_names": "Up_conv3", "weights": 1.0,
                               "contrast_ons": "self"}
    with pytest.raises(NotImplementedError, match=f"{refused} are not ported yet "
                                                  r"\(ROADMAP A12\)"):
        build_trainer(config, save_dir=str(tmp_path), pretrain=True, device="cpu")
