from .functional import class2one_hot, one_hot_check, probs2one_hot, simplex
from .iic import (compute_joint, iid_loss, iid_segmentation_loss,
                  iid_segmentation_small_patch_loss)
from .kl import cross_entropy_onehot, entropy_loss, kl_div
from .pica import pui_loss, pui_seg_loss
from .supcon import (SupConAux, assemble_block_weights, block_soft_supcon_loss,
                     pairwise_mask_from_labels, self_paced_supcon_loss, soft_supcon_loss,
                     supcon_loss, supcon_loss_in_mode)

__all__ = ["class2one_hot", "one_hot_check", "probs2one_hot", "simplex", "compute_joint",
           "iid_loss", "iid_segmentation_loss", "iid_segmentation_small_patch_loss",
           "cross_entropy_onehot", "entropy_loss", "kl_div", "pui_loss", "pui_seg_loss",
           "SupConAux", "assemble_block_weights", "block_soft_supcon_loss",
           "pairwise_mask_from_labels", "self_paced_supcon_loss", "soft_supcon_loss",
           "supcon_loss", "supcon_loss_in_mode"]
