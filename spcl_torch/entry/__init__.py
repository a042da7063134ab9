from .common import (build_model_from_config, build_trainer, load_datasets_from_config,
                     separate_pretrain_finetune_configs)

__all__ = ["build_model_from_config", "build_trainer", "load_datasets_from_config",
           "separate_pretrain_finetune_configs"]
