from .unet import (ARCH_ELEMENTS, DECODER_NAMES, ENCODER_NAMES, UNet, arch_order,
                   get_channel_dim, sort_arch)
from .ema import EMATeacher, ema_update, ramped_alpha, semi_step_alpha
from .discriminator import Discriminator
from .heads import ClusterHead, DenseClusterHead, DenseProjectionHead, ProjectionHead
from .masking import set_trainable_stages, stages_from_range
from .swin_unet import SwinUNet
from .transplant import head_state_dict_from_flax, unet_state_dict_from_flax

__all__ = [
    "ARCH_ELEMENTS", "DECODER_NAMES", "ENCODER_NAMES", "UNet", "arch_order",
    "get_channel_dim", "sort_arch", "EMATeacher", "ema_update", "ramped_alpha",
    "semi_step_alpha", "Discriminator", "ClusterHead", "DenseClusterHead",
    "DenseProjectionHead", "ProjectionHead",
    "set_trainable_stages", "stages_from_range", "head_state_dict_from_flax",
    "unet_state_dict_from_flax", "SwinUNet",
]
