"""Entry-point plumbing: config -> model/data/trainer.

The pretrain branch of `spcl_tpu/entry/common.py` (reference main.py:18-83,
utils.py:7-34, semi_seg/data/creator.py): hook activation by config-block
presence, `pre_`/`ft_` config splitting for the two-phase pipeline, and the
encoder-pretrain trainer wired to the contrastive loader.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

from ..configure.dictionary_utils import (dictionary_merge_by_hierachy,
                                          extract_params_with_key_prefix)
from ..constants import data2class_numbers, data2input_dim
from ..data import (SliceDataset, corrupt_meta_labels, create_contrastive_loader,
                    load_packed, synthetic_dataset, synthetic_dataset_hard)
from ..data.augment import POLICY_ZOO
from ..hooks import create_hook_from_config, feature_until_from_hooks
from ..models import UNet
from ..models.masking import stages_from_range
from ..training import trainer_zoo
from ..utils.utils import get_logger

logger = get_logger("entry")


def separate_pretrain_finetune_configs(config: Dict) -> Tuple[Dict, Dict]:
    """Split one merged CLI config into (pretrain_config, finetune_config)
    via `pre_`/`ft_` key prefixes (reference utils.py:7-34)."""
    base = {k: v for k, v in config.items()}
    pretrain_config = dictionary_merge_by_hierachy(
        base, extract_params_with_key_prefix(config, "pre_"))
    finetune_config = dictionary_merge_by_hierachy(
        base, extract_params_with_key_prefix(config, "ft_"))
    return pretrain_config, finetune_config


def build_model_from_config(config: Dict) -> UNet:
    arch = config.get("Arch", {})
    data_name = (config.get("Data") or {}).get("name", "acdc")
    if str(arch.get("dtype", "float32")) != "float32":
        raise NotImplementedError("Arch.dtype: only float32 is ported yet")
    if str(arch.get("small_c_layout", "nhwc")) not in ("nhwc", "nchw"):
        # "packed"/"pallas" select the fused small-channel stage kernels,
        # which are not ported yet; nhwc/nchw compute the same function
        raise NotImplementedError(f"Arch.small_c_layout={arch['small_c_layout']!r}")
    return UNet(
        input_dim=int(arch.get("input_dim", data2input_dim.get(data_name, 1))),
        num_classes=int(arch.get("num_classes", data2class_numbers.get(data_name, 4))),
        max_channel=int(arch.get("max_channel", 256)),
        momentum=float(arch.get("momentum", 0.1)))


def load_datasets_from_config(config: Dict) -> Tuple[SliceDataset, SliceDataset]:
    """(train, test) datasets of the config's Data block."""
    data = config.get("Data", {})
    name = data.get("name", "acdc")
    canvas = int(data.get("canvas", 256))
    synthetic = data.get("synthetic")
    if synthetic:
        # synthetic: true -> the easy blob fixture; "hard" -> the regime that
        # does not saturate from scratch at low labels (data/packing.py)
        gen = synthetic_dataset_hard if str(synthetic).lower() == "hard" \
            else synthetic_dataset
        tra = gen(name, num_scans=int(data.get("synthetic_scans", 20)),
                  canvas=canvas, seed=0)
        test = gen(name, num_scans=int(data.get("synthetic_test_scans", 8)),
                   canvas=canvas, seed=1, mode="val")
        meta_corrupt = float(data.get("meta_corrupt", 0) or 0)
        if meta_corrupt:
            tra = corrupt_meta_labels(tra, meta_corrupt, seed=777)
        return tra, test
    root = data.get("root")
    if not root:
        raise RuntimeError("Data.root not set (packed .npz directory); "
                           "or set Data.synthetic=true")
    return (load_packed(str(Path(root) / f"{name}_train.npz")),
            load_packed(str(Path(root) / f"{name}_val.npz")))


def build_trainer(config: Dict, *, save_dir: Optional[str] = None,
                  pretrain: bool = False, device="cuda"):
    """Construct a wired (not yet init'ed) encoder-pretrain trainer."""
    data_cfg = config.get("Data", {})
    trainer_cfg = config.get("Trainer", {})
    name = trainer_cfg.get("name") or ("pretrain" if pretrain else "semi")
    if name not in trainer_zoo:
        raise NotImplementedError(
            f"trainer {name!r} is not ported yet (encoder pretraining only)")
    data_name = data_cfg.get("name", "acdc")
    default_crop = POLICY_ZOO.get(data_name, {"val": None})["val"]
    crop = int(data_cfg.get("crop", default_crop.crop if default_crop else 224))
    seed = int(config.get("RandomSeed", 10))

    tra_set, _ = load_datasets_from_config(config)

    max_epoch = int(trainer_cfg.get("max_epoch", 75))
    hooks = create_hook_from_config(config, max_epoch=max_epoch)
    cl_cfg = config.get("ContrastiveLoaderParams", {})
    contrastive_loader = create_contrastive_loader(
        tra_set, scan_sample_num=int(cl_cfg.get("scan_sample_num", 10)),
        partition_sample_num=int(cl_cfg.get("partition_sample_num", 1)),
        seed=seed, use_contrast_sampler=data_name == "acdc")
    until = feature_until_from_hooks(*hooks)
    trainer = trainer_zoo[name](
        model=build_model_from_config(config), contrastive_loader=contrastive_loader,
        save_dir=save_dir or trainer_cfg.get("save_dir", "runs/tmp"),
        max_epoch=max_epoch, num_batches=int(trainer_cfg.get("num_batches", 100)),
        config=config, seed=seed, crop=crop, data_name=data_name,
        forward_until=until, device=device)
    trainer.register_hooks(*hooks)
    trainer.set_trainable_stages(stages_from_range(None, until))
    logger.info("pretrain trainer %s: forward_until=%s", name, until)
    return trainer
