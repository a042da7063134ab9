"""Hook factories: config blocks -> hooks.

The InfoNCE and self-paced InfoNCE parts of `spcl_tpu/hooks/creator.py`
(reference semi_seg/hooks/creator.py:14-124 + hook_creator.py:10-28): hooks
activate by *presence* of their parameter block in the merged config,
scalar-or-list params broadcast over feature names, and
`feature_until_from_hooks` gives the deepest UNet stage any hook needs.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

from .base import CombineTrainerHook, TrainerHook, get_individual_hooks
from .infonce import INFONCEHook, SelfPacedINFONCEHook
from ..models.unet import sort_arch
from ..utils.utils import ntuple

# config blocks of hooks that `spcl_tpu` has and this package does not yet
_NOT_PORTED = ("ConsistencyParams", "MeanTeacherParams", "EntropyMinParams",
               "MixUpParams", "DiscreteMIConsistencyParams", "MineParams",
               "UCMeanTeacherParams", "MIDLPaperParameters")


def feature_until_from_hooks(*hooks: TrainerHook, default: str = "Deconv_1x1") -> str:
    names = [h.feature_name for h in get_individual_hooks(*hooks) if h.feature_name]
    if names:
        return sort_arch(names)[-1]
    return default


def create_infonce_hooks(*, feature_names: Union[str, List[str]],
                         weights: Union[float, List[float]] = 1.0,
                         contrast_ons: Union[str, List[str], None] = None,
                         global_contrast: str = "replicated",
                         **kwargs) -> CombineTrainerHook:
    n = 1 if isinstance(feature_names, str) else len(feature_names)
    brd = ntuple(n)
    hooks = [INFONCEHook(name=f"infonce/{f}/{c}", feature_name=f, weight=w,
                         contrast_on=c, global_contrast=global_contrast)
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


def create_hook_from_config(config: Dict, *, max_epoch: Optional[int] = None
                            ) -> List[TrainerHook]:
    """Activate hooks by config-block presence (reference hook_creator.py:10-28)."""
    missing = [k for k in _NOT_PORTED if k in config]
    if missing:
        raise NotImplementedError(f"hooks not ported yet: {missing}")
    hooks: List[TrainerHook] = []
    if "InfonceParams" in config:
        hooks.append(create_infonce_hooks(**config["InfonceParams"]))
    if "SPInfonceParams" in config:
        params = dict(config["SPInfonceParams"])
        if max_epoch is not None:
            params.setdefault("max_epoch", max_epoch)
        hooks.append(create_sp_infonce_hooks(**params))
    return get_individual_hooks(*hooks)
