from .functional import class2one_hot
from .supcon import SupConAux, self_paced_supcon_loss, supcon_loss

__all__ = ["class2one_hot", "SupConAux", "self_paced_supcon_loss", "supcon_loss"]
