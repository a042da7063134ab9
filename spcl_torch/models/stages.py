"""The architectures of the port by `Arch.name`, and the questions the
trainers and hooks ask of a stage name: which architecture's order it
belongs to, whether it is an encoder stage, and the order of a set of
names. Each model class lists its own stages in forward order
(`ENCODER_NAMES`, `DECODER_NAMES`, `ARCH_ELEMENTS`); a name finds its
model's order because no stage name is in two architectures, which is
checked here at import.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Type

from torch import nn

from .swin_unet import SwinUNet
from .unet import UNet

# Arch.name -> model class: the valid names, and the one list of stages
ARCHITECTURES: Dict[str, Type[nn.Module]] = {"unet": UNet, "swin_unet": SwinUNet}

# stage name -> the class that has it
_OWNER: Dict[str, Type[nn.Module]] = {}
for _cls in ARCHITECTURES.values():
    for _stage in _cls.ARCH_ELEMENTS:
        if _stage in _OWNER:
            raise ValueError(f"stage {_stage!r} is in both {_OWNER[_stage].__name__} and "
                             f"{_cls.__name__}: stage names must be unique across architectures")
        _OWNER[_stage] = _cls


def elements_of(stage: str) -> Tuple[str, ...]:
    """Every stage, in order, of the architecture that has `stage`."""
    if stage not in _OWNER:
        raise ValueError(f"{stage!r} is a stage of no architecture ({sorted(ARCHITECTURES)})")
    return _OWNER[stage].ARCH_ELEMENTS


def is_encoder_stage(stage: str) -> bool:
    return stage in _OWNER and stage in _OWNER[stage].ENCODER_NAMES


def sort_stages(names: Sequence[str], reverse: bool = False) -> List[str]:
    """`names` in their architecture's forward order."""
    if not names:
        return []
    order = elements_of(names[0])
    return sorted(names, key=order.index, reverse=reverse)
