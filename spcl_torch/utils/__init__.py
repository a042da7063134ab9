from .utils import (config_logger, fix_all_seed, fix_all_seed_within_context,
                    get_logger, ntuple, yaml_load)

__all__ = ["config_logger", "fix_all_seed", "fix_all_seed_within_context",
           "get_logger", "ntuple", "yaml_load"]
