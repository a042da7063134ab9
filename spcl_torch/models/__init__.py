from .unet import (ARCH_ELEMENTS, DECODER_NAMES, ENCODER_NAMES, UNet, arch_order,
                   get_channel_dim, sort_arch)
from .heads import ProjectionHead
from .masking import set_trainable_stages, stages_from_range
from .transplant import head_state_dict_from_flax, unet_state_dict_from_flax

__all__ = [
    "ARCH_ELEMENTS", "DECODER_NAMES", "ENCODER_NAMES", "UNet", "arch_order",
    "get_channel_dim", "sort_arch", "ProjectionHead", "set_trainable_stages",
    "stages_from_range", "head_state_dict_from_flax", "unet_state_dict_from_flax",
]
