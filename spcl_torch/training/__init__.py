from .checkpoint import load_checkpoint, load_model_state_dict, safe_save, save_checkpoint
from .optim import RAdam, build_optimizer
from .steps import batch_to_device, build_pretrain_step
from .trainer import PretrainEncoderTrainer, trainer_zoo

__all__ = ["load_checkpoint", "load_model_state_dict", "safe_save", "save_checkpoint",
           "RAdam", "build_optimizer", "batch_to_device", "build_pretrain_step",
           "PretrainEncoderTrainer", "trainer_zoo"]
