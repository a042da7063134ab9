from .gamma import PScheduler, RampScheduler
from .lr import warmup_cosine_epoch_schedule

__all__ = ["PScheduler", "RampScheduler", "warmup_cosine_epoch_schedule"]
