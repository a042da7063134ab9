"""Hook factories: config blocks -> hooks.

The counterpart of `spcl_tpu/hooks/creator.py` (reference
semi_seg/hooks/creator.py:14-124 + hook_creator.py:10-28): hooks activate by
*presence* of their parameter block in the merged config, scalar-or-list
params broadcast over feature names, `feature_until_from_hooks` gives the
deepest UNet stage any hook needs, and `LEGACY_TRAINER_PRESETS` maps the
reference's legacy trainer names to a semi trainer with fixed hook blocks.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

from .base import CombineTrainerHook, TrainerHook, get_individual_hooks
from .consistency import ConsistencyTrainerHook
from .discretemi import DiscreteMITrainHook
from .entmin import EntropyMinTrainerHook
from .infonce import INFONCEHook, SelfPacedINFONCEHook
from .midl import MIDLPaperTrainerHook
from .mine import MineTrainHook
from .mixup import MixUpHook
from .mt import MeanTeacherTrainerHook
from .ucmt import UCMeanTeacherTrainerHook
from ..models.stages import is_encoder_stage, sort_stages
from ..utils.utils import ntuple


def feature_until_from_hooks(*hooks: TrainerHook, default: str = "Deconv_1x1") -> str:
    """The deepest stage any hook reads, in the order of its architecture
    (`models/stages.py`); `default` where no hook reads one."""
    names = [h.feature_name for h in get_individual_hooks(*hooks) if h.feature_name]
    if names:
        return sort_stages(names)[-1]
    return default


def create_infonce_hooks(*, feature_names: Union[str, List[str]],
                         weights: Union[float, List[float]] = 1.0,
                         contrast_ons: Union[str, List[str], None] = None,
                         temperature: float = 0.07, global_contrast: str = "replicated",
                         **kwargs) -> CombineTrainerHook:
    # honours `temperature`, which spcl_tpu drops (as for SPInfonceParams, ROADMAP C2)
    n = 1 if isinstance(feature_names, str) else len(feature_names)
    brd = ntuple(n)
    hooks = [INFONCEHook(name=f"infonce/{f}/{c}", feature_name=f, weight=w,
                         contrast_on=c, temperature=temperature,
                         global_contrast=global_contrast)
             for f, w, c in zip(brd(feature_names), brd(weights), brd(contrast_ons))]
    return CombineTrainerHook(*hooks)


def create_sp_infonce_hooks(*, feature_names: Union[str, List[str]],
                            weights: Union[float, List[float]] = 1.0,
                            contrast_ons: Union[str, List[str], None] = None,
                            begin_values: Union[float, List[float]] = 1e10,
                            end_values: Union[float, List[float]] = 1e10,
                            mode: str = "soft", p: float = 0.5, max_epoch: int = 80,
                            correct_grad: Union[bool, List[bool]] = False,
                            temperature: float = 0.07, use_fused="auto",
                            global_contrast: str = "replicated",
                            **kwargs) -> CombineTrainerHook:
    n = 1 if isinstance(feature_names, str) else len(feature_names)
    brd = ntuple(n)
    hooks = [SelfPacedINFONCEHook(name=f"spinfonce/{f}/{c}", feature_name=f, weight=w,
                                  contrast_on=c, begin_value=b, end_value=e, mode=mode,
                                  p=p, max_epoch=max_epoch, correct_grad=g,
                                  temperature=temperature, use_fused=use_fused,
                                  global_contrast=global_contrast)
             for f, w, c, b, e, g in zip(brd(feature_names), brd(weights),
                                         brd(contrast_ons), brd(begin_values),
                                         brd(end_values), brd(correct_grad))]
    return CombineTrainerHook(*hooks)


def create_consistency_hook(weight: float = 1.0) -> ConsistencyTrainerHook:
    return ConsistencyTrainerHook(name="consistency", weight=weight)


def create_mt_hook(weight: float = 1.0, alpha: float = 0.999) -> MeanTeacherTrainerHook:
    return MeanTeacherTrainerHook(name="mt", weight=weight, alpha=alpha)


def create_ent_min_hook(weight: float = 1.0) -> EntropyMinTrainerHook:
    return EntropyMinTrainerHook(name="entmin", weight=weight)


def create_mixup_hook(weight: float = 1.0, enable_bn: bool = True) -> MixUpHook:
    return MixUpHook(name="mix_reg", weight=weight, enable_bn=enable_bn)


def create_mine_hooks(*, feature_names: Union[str, List[str]],
                      weights: Union[float, List[float]] = 1.0) -> CombineTrainerHook:
    n = 1 if isinstance(feature_names, str) else len(feature_names)
    brd = ntuple(n)
    return CombineTrainerHook(*[MineTrainHook(name=f"mine/{f}", feature_name=f, weight=w)
                                for f, w in zip(brd(feature_names), brd(weights))])


def create_uc_mt_hook(weight: float = 1.0, alpha: float = 0.999,
                      threshold_begin: float = 0.75, threshold_end: float = 0.75,
                      max_epoch: int = 100, **kwargs) -> UCMeanTeacherTrainerHook:
    return UCMeanTeacherTrainerHook(name="ucmt", weight=weight, alpha=alpha,
                                    threshold_begin=threshold_begin,
                                    threshold_end=threshold_end, max_epoch=max_epoch,
                                    **kwargs)


def create_midl_hook(*, iic_weight: float = 1.0, consistency_weight: float = 1.0,
                     padding: int = 7, patch_size: int = 32) -> CombineTrainerHook:
    return CombineTrainerHook(
        MIDLPaperTrainerHook(weight=iic_weight, padding=padding, patch_size=patch_size),
        create_consistency_hook(consistency_weight))


def create_discrete_mi_consistency_hook(*, feature_names: Union[str, List[str]],
                                        mi_weights: Union[float, List[float]],
                                        dense_paddings: Union[int, List[int], None] = None,
                                        consistency_weight: float = 1.0,
                                        num_clusters: int = 20, num_subheads: int = 5
                                        ) -> CombineTrainerHook:
    n = 1 if isinstance(feature_names, str) else len(feature_names)
    brd = ntuple(n)
    feature_names = brd(feature_names)
    n_dense = len([f for f in feature_names if not is_encoder_stage(f)])
    pad_iter = iter(list(ntuple(max(n_dense, 1))(dense_paddings)) if n_dense else [])
    hooks: List[TrainerHook] = []
    for f, w in zip(feature_names, brd(mi_weights)):
        p = next(pad_iter) if not is_encoder_stage(f) else None
        hooks.append(DiscreteMITrainHook(name=f"discreteMI/{f.lower()}", feature_name=f,
                                         weight=w, padding=p, num_clusters=num_clusters,
                                         num_subheads=num_subheads))
    hooks.append(create_consistency_hook(consistency_weight))
    return CombineTrainerHook(*hooks)


def create_hook_from_config(config: Dict, *, max_epoch: Optional[int] = None
                            ) -> List[TrainerHook]:
    """Activate hooks by config-block presence (reference hook_creator.py:10-28)."""
    hooks: List[TrainerHook] = []
    if "InfonceParams" in config:
        hooks.append(create_infonce_hooks(**config["InfonceParams"]))
    if "SPInfonceParams" in config:
        params = dict(config["SPInfonceParams"])
        if max_epoch is not None:
            params.setdefault("max_epoch", max_epoch)
        hooks.append(create_sp_infonce_hooks(**params))
    if "ConsistencyParams" in config:
        hooks.append(create_consistency_hook(**config["ConsistencyParams"]))
    if "MeanTeacherParams" in config:
        hooks.append(create_mt_hook(**config["MeanTeacherParams"]))
    if "EntropyMinParams" in config:
        hooks.append(create_ent_min_hook(**config["EntropyMinParams"]))
    if "MixUpParams" in config:
        hooks.append(create_mixup_hook(**config["MixUpParams"]))
    if "DiscreteMIConsistencyParams" in config:
        hooks.append(create_discrete_mi_consistency_hook(
            **config["DiscreteMIConsistencyParams"]))
    if "MineParams" in config:
        hooks.append(create_mine_hooks(**config["MineParams"]))
    if "UCMeanTeacherParams" in config:
        params = dict(config["UCMeanTeacherParams"])
        if max_epoch is not None:
            params.setdefault("max_epoch", max_epoch)
        hooks.append(create_uc_mt_hook(**params))
    if "MIDLPaperParameters" in config:
        hooks.append(create_midl_hook(**config["MIDLPaperParameters"]))
    return get_individual_hooks(*hooks)


# Legacy trainer-name presets (reference semi_seg/trainers/__init__.py:5-23):
# each legacy trainer is a semi trainer plus a fixed hook configuration
LEGACY_TRAINER_PRESETS = {
    "uda": {"ConsistencyParams": {"weight": 1.0}},
    "entropy": {"EntropyMinParams": {"weight": 0.1}},
    "meanteacher": {"MeanTeacherParams": {"weight": 1.0}},
    "ucmeanteacher": {"UCMeanTeacherParams": {"weight": 1.0}},
    "iic": {"DiscreteMIConsistencyParams": {"feature_names": ["Conv5"],
                                            "mi_weights": 0.1, "consistency_weight": 0.0}},
    "udaiic": {"DiscreteMIConsistencyParams": {"feature_names": ["Conv5", "Up_conv3", "Up_conv2"],
                                               "mi_weights": [0.1, 0.05, 0.05],
                                               "dense_paddings": 0,
                                               "consistency_weight": 1.0}},
    "midl": {"MIDLPaperParameters": {"iic_weight": 0.1, "consistency_weight": 1.0}},
    "mine": {"MineParams": {"feature_names": "Conv5", "weights": 0.1}},
    "infonce": {"InfonceParams": {"feature_names": "Conv5", "weights": 1.0,
                                  "contrast_ons": "partition"}},
    "infoncemt": {"InfonceParams": {"feature_names": "Conv5", "weights": 1.0,
                                    "contrast_ons": "partition"},
                  "MeanTeacherParams": {"weight": 1.0}},
    "iicmeanteacher": {"DiscreteMIConsistencyParams": {"feature_names": ["Conv5"],
                                                       "mi_weights": 0.1,
                                                       "consistency_weight": 0.0},
                       "MeanTeacherParams": {"weight": 1.0}},
}
