from .supcon import SupConAux, self_paced_supcon_loss, supcon_loss

__all__ = ["SupConAux", "self_paced_supcon_loss", "supcon_loss"]
