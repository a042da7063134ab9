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
from .creator import (LEGACY_TRAINER_PRESETS, create_consistency_hook,
                      create_discrete_mi_consistency_hook, create_ent_min_hook,
                      create_hook_from_config, create_infonce_hooks, create_midl_hook,
                      create_mine_hooks, create_mixup_hook, create_mt_hook,
                      create_sp_infonce_hooks, create_uc_mt_hook, feature_until_from_hooks)

__all__ = ["CombineTrainerHook", "TrainerHook", "get_individual_hooks",
           "label_from_contrast_on", "ConsistencyTrainerHook", "DiscreteMITrainHook",
           "EntropyMinTrainerHook", "INFONCEHook", "SelfPacedINFONCEHook",
           "MIDLPaperTrainerHook", "MineTrainHook", "MixUpHook", "MeanTeacherTrainerHook",
           "UCMeanTeacherTrainerHook", "LEGACY_TRAINER_PRESETS", "create_hook_from_config",
           "create_infonce_hooks", "create_sp_infonce_hooks", "create_consistency_hook",
           "create_discrete_mi_consistency_hook", "create_ent_min_hook", "create_midl_hook",
           "create_mine_hooks", "create_mixup_hook", "create_mt_hook", "create_uc_mt_hook",
           "feature_until_from_hooks"]
