"""Fine-tune sweep over labeled ratios from pretrained weights.

The counterpart of `spcl_tpu/entry/val.py` (reference val.py:24-66): for each
labeled scan count in the dataset's ratio zoo, warm-start the model from the
pretrained checkpoint, rebuild the loaders at that ratio, and run a full
FineTuneTrainer with eval. Returns {ratio: best val DSC}.

Under `Trainer.mesh` every rank calls `val` with the same config; the
pretrain trainer's closing barrier guarantees that `pretrained_checkpoint`,
written by rank 0, is complete before any rank reads it here.
"""
from __future__ import annotations

import copy
from pathlib import Path
from typing import Dict, List, Optional

from .common import build_trainer
from ..constants import ft_lr_zooms, ft_max_epoch_zoo, num_batches_zoo, ratio_zoo
from ..utils.utils import get_logger

logger = get_logger("entry.val")


def val(*, base_config: Dict, pretrained_checkpoint: str, save_dir: str,
        labeled_ratios: Optional[List[int]] = None, device="cuda") -> Dict[int, float]:
    data_name = base_config.get("Data", {}).get("name", "acdc")
    ratios = (labeled_ratios or base_config.get("Data", {}).get("ratios")
              or ratio_zoo.get(data_name, [1]))
    results: Dict[int, float] = {}
    for ratio in ratios:
        config = copy.deepcopy(base_config)
        config.setdefault("Data", {})["labeled_scan_num"] = int(ratio)
        config.setdefault("Arch", {})["checkpoint"] = str(pretrained_checkpoint)
        config.setdefault("Trainer", {})
        config["Trainer"]["name"] = "ft"
        config["Trainer"].setdefault("max_epoch", ft_max_epoch_zoo.get(data_name, 60))
        config["Trainer"].setdefault("num_batches", num_batches_zoo.get(data_name, 200))
        config.setdefault("Optim", {}).setdefault("lr", ft_lr_zooms.get(data_name, 2e-7))
        run_dir = str(Path(save_dir) / f"tra_{ratio}")
        trainer = build_trainer(config, save_dir=run_dir, device=device)
        trainer.init()
        best = trainer.start_training()
        results[ratio] = best
        logger.info("finetune ratio=%s -> best DSC %.4f", ratio, best)
    return results
