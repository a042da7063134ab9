"""Trainer keys that spcl_tpu honours and spcl_torch does not port yet are
refused, not ignored: a non-default value of `Trainer.grad_cache`,
`dump_matrices`, `profile_dir` or `defer_reads` raises NotImplementedError
naming the key and its ROADMAP item, while the paper's configuration
(base.yaml + pretrain.yaml + specific/selfpaced_infonce.yaml) still builds.
CPU only; the refused cases raise before any data is loaded."""
from pathlib import Path

import pytest

from spcl_torch import CONFIG_PATH
from spcl_torch.configure import ConfigManager
from spcl_torch.entry import build_trainer

PAPER = str(Path(CONFIG_PATH) / "specific" / "selfpaced_infonce.yaml")


@pytest.mark.parametrize("override,refused", [
    ("Trainer.grad_cache=30", "Trainer.grad_cache=30 is not ported yet (ROADMAP A13)"),
    ("Trainer.dump_matrices=true", "Trainer.dump_matrices=True is not ported yet (ROADMAP A7)"),
    ("Trainer.profile_dir=runs/prof",
     "Trainer.profile_dir='runs/prof' is not ported yet (ROADMAP A7)"),
    ("Trainer.defer_reads=true", "Trainer.defer_reads=True is not ported yet (ROADMAP A7)"),
    ("Trainer.device_data=true", None),  # the paper's configuration as base.yaml sets it
])
def test_unported_trainer_keys_are_refused(tmp_path, override, refused):
    config = ConfigManager(str(Path(CONFIG_PATH) / "base.yaml"),
                           str(Path(CONFIG_PATH) / "pretrain.yaml"), strict=False).parse_args(
        ["Data.synthetic=true", override, "--opt-path", PAPER]).merged_config
    config["Trainer"]["name"] = "pretrain_encoder"
    if refused is not None:
        with pytest.raises(NotImplementedError) as err:
            build_trainer(config, save_dir=str(tmp_path), pretrain=True, device="cpu")
        assert str(err.value) == refused
        return
    trainer = build_trainer(config, save_dir=str(tmp_path), pretrain=True, device="cpu")
    assert trainer._forward_until == "Conv5"
    assert config["Trainer"]["grad_cache"] == 0 and config["Trainer"]["profile_dir"] is None
