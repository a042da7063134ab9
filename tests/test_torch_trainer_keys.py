"""Trainer keys that spcl_tpu honours and spcl_torch does not port yet are
refused, not ignored: a non-default value of `Trainer.dump_matrices`,
`profile_dir` or `defer_reads` raises NotImplementedError naming the key and
its ROADMAP item, while the paper's configuration (base.yaml + pretrain.yaml
+ specific/selfpaced_infonce.yaml) still builds, and so does it with
`Trainer.grad_cache=30` (ported: the trainer's step is then the gradient
cache's, with 30 chunks). `dump_matrices` together with `grad_cache` raises
spcl_tpu's ValueError. The semi and mixup trainers build (`semi` with
production_semi.yaml + mt.yaml + uda.yaml, as `chip_smoke.py` runs it);
`Trainer.mesh` with either, or with the adversarial trainer, raises
NotImplementedError until ROADMAP A12 (rest), and so does a decoder-stage
InfoNCE hook under a mesh or with `Trainer.grad_cache`. CPU only; the
refused cases raise before any data is loaded."""
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
    ("Trainer.dump_matrices=true", "Trainer.dump_matrices=True is not ported yet (ROADMAP A7)"),
    ("Trainer.profile_dir=runs/prof",
     "Trainer.profile_dir='runs/prof' is not ported yet (ROADMAP A7)"),
    ("Trainer.defer_reads=true", "Trainer.defer_reads=True is not ported yet (ROADMAP A7)"),
    ("Trainer.device_data=true", None),  # the paper's configuration as base.yaml sets it
])
def test_unported_trainer_keys_are_refused(tmp_path, override, refused):
    config = _config(override)
    if refused is not None:
        with pytest.raises(NotImplementedError) as err:
            build_trainer(config, save_dir=str(tmp_path), pretrain=True, device="cpu")
        assert str(err.value) == refused
        return
    trainer = build_trainer(config, save_dir=str(tmp_path), pretrain=True, device="cpu")
    assert trainer._forward_until == "Conv5"
    assert config["Trainer"]["profile_dir"] is None
    trainer.init()
    chunks = getattr(trainer._train_step, "num_chunks", None)
    assert chunks == (30 if override == "Trainer.grad_cache=30" else None)


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
