from .gamma import (ExpScheduler, InverseExpScheduler, LinearScheduler, PScheduler,
                    RampScheduler, _EpochScheduler)
from .lr import warmup_cosine_epoch_schedule

# the deepclustering2 name of the base every gamma / weight schedule derives from
WeightScheduler = _EpochScheduler

__all__ = ["ExpScheduler", "InverseExpScheduler", "LinearScheduler", "PScheduler",
           "RampScheduler", "WeightScheduler", "warmup_cosine_epoch_schedule"]
