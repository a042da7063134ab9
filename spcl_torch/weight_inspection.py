#!/usr/bin/env python
"""Offline inspection of the self-paced weight matrices: the counterpart of
the root `weight_inspection.py` (reference semi_seg/weight_inspection.py:10-64).

    python -m spcl_torch.weight_inspection Arch.checkpoint=runs/sp/pre/last.ckpt \
        Trainer.save_dir=runs/inspect [Data.synthetic=true] \
        [--device cuda] --opt-path config/hooks/spinfonce.yaml

Merges config/base.yaml + config/pretrain.yaml with the overrides (needs
pyyaml), builds the pretrain trainer (`Arch.checkpoint` warm-starts the UNet;
the projector is the hook's fresh one, as in spcl_tpu), takes the first
contrastive batch, makes two augmented views and runs the eval-mode UNet up
to the first InfoNCE hook's feature, then its projector. For each gamma it
evaluates the dense self-paced SupCon (soft weights) and writes the
similarity logits, the positive mask and the self-paced weights to
`<save_dir>/weight_inspection.npz` under spcl_tpu's key names
(`gamma_<g>/sim_logits`, `pos_mask`, `sp_mask`).

The views' draws come from a `torch.Generator` seeded by `RandomSeed`, or are
handed in (`draws`: the `sample_twice` dict), since the two packages' random
streams differ.
"""
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from spcl_torch import CONFIG_PATH
from spcl_torch.configure import ConfigManager
from spcl_torch.data.augment import augment_twice, sample_twice
from spcl_torch.entry import build_trainer
from spcl_torch.losses import self_paced_supcon_loss
from spcl_torch.main import cli
from spcl_torch.training.steps import _as_float_image
from spcl_torch.utils import config_logger, fix_all_seed

GAMMAS = (1.0, 3.0, 10.0, 100.0)
MATRICES = ("sim_logits", "pos_mask", "sp_mask")


def inspect(config, save_dir: str, gammas: Sequence[float] = GAMMAS, *, device="cuda",
            draws: Optional[Dict] = None) -> Dict[str, Dict]:
    """Build and init the pretrain trainer of `config`, then `inspect_trainer`."""
    trainer = build_trainer(config, save_dir=save_dir, pretrain=True, device=device)
    trainer.init()
    return inspect_trainer(trainer, save_dir, gammas, draws=draws,
                           seed=int(config.get("RandomSeed", 10)))


@torch.no_grad()
def inspect_trainer(trainer, save_dir: str, gammas: Sequence[float] = GAMMAS, *,
                    draws: Optional[Dict] = None, seed: int = 10) -> Dict[str, Dict]:
    """{"gamma_<g>": {"loss", "downgrade_ratio", "sim_logits", "pos_mask",
    "sp_mask"}} for an init'ed pretrain trainer; writes the npz."""
    hooks = [h for h in trainer.hooks if h.feature_name]
    if not hooks:
        raise ValueError("the config must activate an (sp)infonce hook")
    hook = hooks[0]
    device = trainer._device
    batch = next(iter(trainer._contrastive_loader))
    image = _as_float_image(torch.from_numpy(batch["image"]).to(device))
    policy = trainer.train_policy
    if draws is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        draws = sample_twice(gen, image.shape[0], policy, image.shape[-1], True, None, device)
    (v1, _), (v2, _) = augment_twice(image, None, policy, draws)
    model = trainer.model
    model.eval()
    acts = model(torch.cat([v1, v2], dim=0), until=hook.feature_name)
    z = hook.projector(acts[hook.feature_name])
    n = v1.shape[0]
    target = torch.from_numpy(batch["partition"]).to(device)
    valid = torch.from_numpy(batch["valid"]).to(device)

    out = {}
    for gamma in gammas:
        loss, aux = self_paced_supcon_loss(z[:n], z[n:], gamma=gamma, target=target,
                                           valid=valid, weight_update="soft",
                                           return_matrices=True)
        out[f"gamma_{gamma}"] = dict(
            loss=float(loss), downgrade_ratio=float(aux.downgrade_ratio),
            **{k: getattr(aux, k).cpu().numpy() for k in MATRICES})
        print(f"gamma={gamma}: loss={float(loss):.4f} "
              f"kept_ratio={float(aux.downgrade_ratio):.4f}")

    Path(save_dir).mkdir(parents=True, exist_ok=True)
    np.savez_compressed(Path(save_dir) / "weight_inspection.npz",
                        **{f"{g}/{k}": d[k] for g, d in out.items() for k in MATRICES})
    return out


def main(argv=None, *, device="cuda"):
    cm = ConfigManager(str(Path(CONFIG_PATH) / "base.yaml"),
                       str(Path(CONFIG_PATH) / "pretrain.yaml"),
                       strict=False).parse_args(argv)
    config = cm.merged_config
    save_dir = config.get("Trainer", {}).get("save_dir", "runs/inspect")
    config_logger(save_dir)
    fix_all_seed(int(config.get("RandomSeed", 10)))
    return inspect(config, save_dir, device=device)


if __name__ == "__main__":
    cli(main)
