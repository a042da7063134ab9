from .base import CombineTrainerHook, TrainerHook, get_individual_hooks, label_from_contrast_on
from .infonce import INFONCEHook, SelfPacedINFONCEHook
from .creator import (create_hook_from_config, create_infonce_hooks,
                      create_sp_infonce_hooks, feature_until_from_hooks)

__all__ = ["CombineTrainerHook", "TrainerHook", "get_individual_hooks",
           "label_from_contrast_on", "INFONCEHook", "SelfPacedINFONCEHook",
           "create_hook_from_config", "create_infonce_hooks", "create_sp_infonce_hooks",
           "feature_until_from_hooks"]
