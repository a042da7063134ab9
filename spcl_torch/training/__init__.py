from .checkpoint import load_checkpoint, load_model_state_dict, safe_save, save_checkpoint
from .gradcache import build_gradcache_pretrain_step
from .optim import SGD, Adam, AdamW, RAdam, build_optimizer
from .steps import (batch_to_device, build_adversarial_step, build_eval_step,
                    build_finetune_step, build_matrix_probe, build_pretrain_step,
                    build_semi_step, draw_adversarial_params, draw_semi_params)
from .trainer import (AdversarialTrainer, FineTuneTrainer, MixUpTrainer,
                      PretrainDecoderTrainer, PretrainEncoderTrainer, SemiTrainer, Trainer,
                      trainer_zoo)

__all__ = ["load_checkpoint", "load_model_state_dict", "safe_save", "save_checkpoint",
           "build_gradcache_pretrain_step", "Adam", "AdamW", "RAdam", "SGD",
           "build_optimizer", "batch_to_device", "build_adversarial_step", "build_eval_step",
           "build_finetune_step", "build_matrix_probe", "build_pretrain_step", "build_semi_step",
           "draw_adversarial_params", "draw_semi_params", "AdversarialTrainer",
           "FineTuneTrainer", "MixUpTrainer", "PretrainDecoderTrainer",
           "PretrainEncoderTrainer", "SemiTrainer", "Trainer", "trainer_zoo"]
