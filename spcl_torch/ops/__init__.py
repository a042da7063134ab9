from .supcon_cuda import (LAUNCHES, FusedSupCon, fused_self_paced_supcon, fused_supcon,
                          reset_launch_counts, sharded_fused_self_paced_supcon)

__all__ = ["LAUNCHES", "FusedSupCon", "fused_self_paced_supcon", "fused_supcon",
           "reset_launch_counts", "sharded_fused_self_paced_supcon"]
