"""spcl_torch — self-paced contrastive learning in PyTorch, with CUDA kernels
for NVIDIA Hopper (H100).

The PyTorch counterpart of `spcl_tpu`, laid out like it so that each module
has its counterpart at the same path. Images and activations are NCHW.
Entry points take an explicit `device` argument whose default is "cuda";
pass device="cpu" to run on the CPU, where the hand-written kernels give way
to their plain PyTorch versions.

This package imports torch and numpy, never jax and never `spcl_tpu`.
"""
from pathlib import Path

__version__ = "0.1.0"

PROJECT_PATH = str(Path(__file__).parents[1])
CONFIG_PATH = str(Path(PROJECT_PATH) / "config")


def success(save_dir: str) -> None:
    """Touch a `.success` marker in the run dir on completion."""
    Path(save_dir).mkdir(parents=True, exist_ok=True)
    (Path(save_dir) / ".success").touch()
