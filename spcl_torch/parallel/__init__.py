"""Multi-rank training: `mesh` (process group, collectives, launcher) and
`contrastive` (the global-batch losses). `contrastive` builds on
`ops.supcon_cuda`, which itself uses `mesh`, so it is imported by its path
(`spcl_torch.parallel.contrastive`) and not from here."""
from . import mesh
from .mesh import (all_gather_cat, all_reduce_grads, all_reduce_sum, grad_share, host_barrier,
                   initialize_distributed, on_master, pad_multiple, rank, shard_rows,
                   spawn_local, world_size)

__all__ = ["mesh", "all_gather_cat", "all_reduce_grads", "all_reduce_sum", "grad_share",
           "host_barrier", "initialize_distributed", "on_master", "pad_multiple", "rank",
           "shard_rows", "spawn_local", "world_size"]
