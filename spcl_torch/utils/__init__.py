from .utils import (ExceptionIgnorer, class_name, config_logger, fix_all_seed,
                    fix_all_seed_within_context, flatten_dict, gethash, get_logger, item2str,
                    nlist, ntuple, path2Path, to_device, to_float, to_numpy, yaml_load,
                    yaml_write)

__all__ = ["ExceptionIgnorer", "class_name", "config_logger", "fix_all_seed",
           "fix_all_seed_within_context", "flatten_dict", "gethash", "get_logger", "item2str",
           "nlist", "ntuple", "path2Path", "to_device", "to_float", "to_numpy", "yaml_load",
           "yaml_write"]
