"""Entry-point plumbing: config -> model/data/trainer.

The counterpart of `spcl_tpu/entry/common.py` (reference main.py:18-83,
utils.py:7-34, semi_seg/data/creator.py): trainer dispatch by `Trainer.name`
(the legacy preset names become the semi trainer with their hook blocks),
hook activation by config-block presence, `pre_`/`ft_` config splitting for
the two-phase pipeline, the encoder- and decoder-pretrain trainers wired to
the contrastive loader, and the fine-tune, mixup, semi and adversarial
trainers to the labeled (and unlabeled), val and test loaders.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..configure.dictionary_utils import (dictionary_merge_by_hierachy,
                                          extract_params_with_key_prefix)
from ..constants import data2class_numbers, data2input_dim
from ..data import (SliceDataset, corrupt_meta_labels, create_contrastive_loader, get_data,
                    load_packed, synthetic_dataset, synthetic_dataset_hard)
from ..data.augment import POLICY_ZOO
from ..hooks import (LEGACY_TRAINER_PRESETS, create_hook_from_config,
                     feature_until_from_hooks, get_individual_hooks)
from ..models import ENCODER_NAMES, UNet
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


# Arch.dtype -> the UNet's compute dtype (spcl_tpu entry/common.py:43-44)
ARCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model_from_config(config: Dict) -> UNet:
    arch = config.get("Arch", {})
    data_name = (config.get("Data") or {}).get("name", "acdc")
    dtype = str(arch.get("dtype", "float32"))
    if dtype not in ARCH_DTYPES:
        raise ValueError(f"Arch.dtype must be one of {sorted(ARCH_DTYPES)}, got {dtype!r}")
    layout = str(arch.get("small_c_layout", "nhwc"))
    if layout == "packed":
        # the pure-jnp lane-packed layout fills the TPU's 128 lanes and has no
        # kernel behind it: there is nothing to port. "pallas" selects the
        # fused stage kernels; nhwc/nchw compute the same function plainly
        raise NotImplementedError(
            "Arch.small_c_layout='packed' is a TPU lane layout without a kernel; "
            "use 'pallas' (fused CUDA stages) or 'nhwc'")
    return UNet(
        small_c_layout=layout,
        input_dim=int(arch.get("input_dim", data2input_dim.get(data_name, 1))),
        num_classes=int(arch.get("num_classes", data2class_numbers.get(data_name, 4))),
        max_channel=int(arch.get("max_channel", 256)),
        momentum=float(arch.get("momentum", 0.1)),
        dtype=ARCH_DTYPES[dtype])


# (train, test) per Data block, as spcl_tpu keeps them (entry/common.py:56-94)
_DATASET_CACHE: Dict[tuple, Tuple[SliceDataset, SliceDataset]] = {}


def load_datasets_from_config(config: Dict) -> Tuple[SliceDataset, SliceDataset]:
    """(train, test) datasets of the config's Data block, loaded once per
    process: the runs of a fine-tune sweep share the same ROOT datasets and
    so one device store each (`data/device_store.py`)."""
    data = config.get("Data", {})
    name = data.get("name", "acdc")
    canvas = int(data.get("canvas", 256))
    synthetic = data.get("synthetic")
    key = (name, canvas, str(synthetic), int(data.get("synthetic_scans", 20)),
           int(data.get("synthetic_test_scans", 8)), data.get("root"),
           float(data.get("meta_corrupt", 0) or 0))
    if key not in _DATASET_CACHE:
        _DATASET_CACHE[key] = _load_datasets(data, name, canvas, synthetic)
    return _DATASET_CACHE[key]


def _load_datasets(data: Dict, name: str, canvas: int, synthetic):
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


def refuse_incompatible_trainer_keys(trainer_cfg: Dict, name: str) -> None:
    """`Trainer.dump_matrices` together with `grad_cache` in a pretrain
    trainer is spcl_tpu's ValueError (trainer.py:1152-1158): the probe's
    whole-batch [2N, 2N] matrices bring back the memory wall that grad_cache
    removes."""
    if (name.startswith("pretrain") and int(trainer_cfg.get("grad_cache") or 0)
            and trainer_cfg.get("dump_matrices")):
        raise ValueError("Trainer.dump_matrices is incompatible with "
                         "Trainer.grad_cache — disable one")


def _refuse_decoder_hooks(hooks, grad_cache: int) -> None:
    """A decoder-stage hook does not run under the gradient cache, as
    spcl_tpu refuses it (training/gradcache.py:75-79): its dense point
    sampling is batch-local."""
    dense = [h.name for h in get_individual_hooks(*hooks)
             if h.feature_name is not None and h.feature_name not in ENCODER_NAMES]
    if dense and grad_cache:
        raise NotImplementedError(
            f"decoder-stage hooks {dense} with Trainer.grad_cache: grad_cache supports "
            "encoder contrastive hooks (dense point sampling is batch-local and does not "
            "benefit from a global batch; spcl_tpu/training/gradcache.py:75-79)")


def build_trainer(config: Dict, *, save_dir: Optional[str] = None,
                  pretrain: bool = False, device="cuda"):
    """Construct a wired (not yet init'ed) trainer from a config: the
    encoder-pretrain trainer (`pretrain`, `pretrain_encoder`: the stages up to
    the hooks' deepest train; `infoncepretrain`: the same with the `infonce`
    preset's InfonceParams under the config's, explicit blocks winning), the
    decoder-pretrain trainer
    (`pretrain_decoder`: Conv5 up to the hooks' deepest stage train, the
    encoder below Conv5 is frozen, spcl_tpu entry/common.py:165-171), the
    fine-tune trainer (`ft`), the mixup trainer (`mixup`), the adversarial
    trainer (`adv`: `Trainer.reg_weight`, `Trainer.dis_consider_image`) or
    the semi trainer (`semi`, the default, and every name of
    `LEGACY_TRAINER_PRESETS`: the preset's hook blocks under the config's,
    explicit blocks winning). The trainer reads `Optim` (name, lr,
    weight_decay, momentum, nesterov, as spcl_tpu's does),
    `Trainer.grad_cache`, `Trainer.packed_eval`, `Trainer.two_stage` and
    `Trainer.disable_bn` from the config; `Trainer.device_data` (default
    true) picks the data path; `Trainer.defer_reads` (+ `flush_every`),
    `profile_dir` and, in the pretrain trainers, `dump_matrices` are
    honoured as spcl_tpu honours them (training/trainer.py), and
    `Arch.dtype` (float32 | bfloat16) is the UNet's compute dtype.
    `Trainer.mesh: N|auto` makes any of these trainers one rank of an N-rank
    run; the calling process must then be one of N ranks (the entry points
    start them through `parallel.mesh.run_ranks`, or start one process per
    rank with the SPCL_* variables). A decoder-stage hook with
    `Trainer.grad_cache` is refused, in spcl_tpu's words."""
    data_cfg = config.get("Data", {})
    trainer_cfg = config.get("Trainer", {})
    name = trainer_cfg.get("name") or ("pretrain" if pretrain else "semi")
    if name == "infoncepretrain":
        # the infonce preset's hook block under the encoder-pretrain trainer,
        # explicit blocks winning (spcl_tpu entry/common.py:111-115)
        config = dictionary_merge_by_hierachy(LEGACY_TRAINER_PRESETS["infonce"], config)
        name = "pretrain"
        pretrain = True
    elif name in LEGACY_TRAINER_PRESETS:
        # legacy trainer zoo (reference semi_seg/trainers/__init__.py:5-23)
        config = dictionary_merge_by_hierachy(LEGACY_TRAINER_PRESETS[name], config)
        name = "semi"
    if name not in trainer_zoo:
        raise NotImplementedError(f"trainer {name!r} is not ported yet "
                                  f"(ported: {sorted(trainer_zoo)})")
    refuse_incompatible_trainer_keys(trainer_cfg, name)
    data_name = data_cfg.get("name", "acdc")
    default_crop = POLICY_ZOO.get(data_name, {"val": None})["val"]
    crop = int(data_cfg.get("crop", default_crop.crop if default_crop else 224))
    seed = int(config.get("RandomSeed", 10))

    tra_set, test_set = load_datasets_from_config(config)

    max_epoch = int(trainer_cfg.get("max_epoch", 75))
    kwargs = dict(model=build_model_from_config(config),
                  save_dir=save_dir or trainer_cfg.get("save_dir", "runs/tmp"),
                  max_epoch=max_epoch, num_batches=int(trainer_cfg.get("num_batches", 100)),
                  config=config, seed=seed, crop=crop, data_name=data_name, device=device,
                  mesh=trainer_cfg.get("mesh", 0),
                  device_data=bool(trainer_cfg.get("device_data", True)),
                  defer_reads=bool(trainer_cfg.get("defer_reads", False)))

    if name.startswith("pretrain"):
        hooks = create_hook_from_config(config, max_epoch=max_epoch)
        _refuse_decoder_hooks(hooks, int(trainer_cfg.get("grad_cache") or 0))
        cl_cfg = config.get("ContrastiveLoaderParams", {})
        contrastive_loader = create_contrastive_loader(
            tra_set, scan_sample_num=int(cl_cfg.get("scan_sample_num", 10)),
            partition_sample_num=int(cl_cfg.get("partition_sample_num", 1)),
            seed=seed, use_contrast_sampler=data_name == "acdc")
        until = feature_until_from_hooks(*hooks)
        trainer = trainer_zoo[name](contrastive_loader=contrastive_loader,
                                    forward_until=until, **kwargs)
        trainer.register_hooks(*hooks)
        # decoder pretraining trains Conv5 up to `until` (reference
        # main_pretrain_decoder.py:42-76 set_grad(True, "Conv5", until))
        start = "Conv5" if name == "pretrain_decoder" else None
        trainer.set_trainable_stages(stages_from_range(start, until))
        logger.info("pretrain trainer %s: forward_until=%s", name, until)
        return trainer

    lab, unlab, val_loader, test_loader = get_data(
        tra_set=tra_set, test_set=test_set,
        labeled_scan_num=int(data_cfg.get("labeled_scan_num", 1)),
        labeled_batch_size=int((config.get("LabeledLoader") or {}).get("batch_size", 5)),
        unlabeled_batch_size=int((config.get("UnlabeledLoader") or {}).get("batch_size", 5)),
        pretrain=pretrain, seed=1,
        load_predefined_list=not bool(data_cfg.get("synthetic", False)))
    trainer_cls = trainer_zoo[name]
    if name == "semi":
        kwargs.update(unlabeled_loader=unlab,
                      two_stage=bool(trainer_cfg.get("two_stage", False)),
                      disable_bn=bool(trainer_cfg.get("disable_bn", False)))
    elif name == "adv":
        kwargs.update(unlabeled_loader=unlab,
                      reg_weight=float(trainer_cfg.get("reg_weight", 0.01)),
                      dis_consider_image=bool(trainer_cfg.get("dis_consider_image", False)))
    trainer = trainer_cls(labeled_loader=lab, val_loader=val_loader, test_loader=test_loader,
                          **kwargs)
    # fine-tuning activates no hooks (reference FineTuneTrainer.activate_hooks)
    if trainer.activate_hooks:
        trainer.register_hooks(*create_hook_from_config(config, max_epoch=max_epoch))
    return trainer
