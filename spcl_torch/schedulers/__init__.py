from .gamma import PScheduler
from .lr import warmup_cosine_epoch_schedule

__all__ = ["PScheduler", "warmup_cosine_epoch_schedule"]
