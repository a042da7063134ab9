"""Learning-rate schedule: gradual warmup x multiplier, then cosine annealing.

The counterpart of `spcl_tpu/schedulers/lr.py` (reference
contrastyou/trainer/base.py:71-83): CosineAnnealingLR(T_max = max_epoch -
warmup_max, eta_min=1e-7) wrapped in GradualWarmupScheduler(multiplier,
total_epoch=warmup_max), stepped once per EPOCH. The schedule maps an
optimizer step to its epoch with `steps_per_epoch`, as the JAX schedule does:

  epoch <  warmup: lr = base * ((multiplier - 1) * epoch / warmup + 1)
  epoch >= warmup: cosine from base*multiplier down to eta_min over T_max.
"""
from __future__ import annotations

import math


def warmup_cosine_epoch_schedule(*, base_lr: float, multiplier: float, warmup_max: int,
                                 max_epoch: int, steps_per_epoch: int,
                                 eta_min: float = 1e-7):
    """Returns schedule(step) -> lr (a python float)."""
    base_lr = float(base_lr)
    multiplier = float(multiplier)
    peak = base_lr * multiplier
    t_max = max(int(max_epoch) - int(warmup_max), 1)

    def schedule(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        if epoch < warmup_max:
            return base_lr * ((multiplier - 1.0) * epoch / max(warmup_max, 1) + 1.0)
        cos_epoch = min(max(epoch - warmup_max, 0), t_max)
        return eta_min + (peak - eta_min) * 0.5 * (1.0 + math.cos(math.pi * cos_epoch / t_max))

    return schedule
