from .base import CombineTrainerHook, TrainerHook, get_individual_hooks, label_from_contrast_on
from .consistency import ConsistencyTrainerHook
from .discretemi import DiscreteMITrainHook
from .entmin import EntropyMinTrainerHook
from .infonce import INFONCEHook, SelfPacedINFONCEHook
from .midl import MIDLPaperTrainerHook
from .mine import MineTrainHook
from .mixup import MixUpHook
from .mt import MeanTeacherTrainerHook
from .ucmt import UCMeanTeacherTrainerHook
from .creator import (LEGACY_TRAINER_PRESETS, create_hook_from_config, create_infonce_hooks,
                      create_sp_infonce_hooks, feature_until_from_hooks)

__all__ = ["CombineTrainerHook", "TrainerHook", "get_individual_hooks",
           "label_from_contrast_on", "ConsistencyTrainerHook", "DiscreteMITrainHook",
           "EntropyMinTrainerHook", "INFONCEHook", "SelfPacedINFONCEHook",
           "MIDLPaperTrainerHook", "MineTrainHook", "MixUpHook", "MeanTeacherTrainerHook",
           "UCMeanTeacherTrainerHook", "LEGACY_TRAINER_PRESETS", "create_hook_from_config",
           "create_infonce_hooks", "create_sp_infonce_hooks", "feature_until_from_hooks"]
