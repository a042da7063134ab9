"""Checkpoint save/load.

The reference's policy (contrastyou/trainer/_io.py:15-134), as
`spcl_tpu/training/checkpoint.py` keeps it: `last.ckpt` written atomically
(tempfile + rename, `safe_save`), the model under the reference's "_model"
key as a torch UNet state_dict (so `load_state_dict(..., strict=True)` on a
fresh `models.unet.UNet` restores it), beside the projector heads, the
optimizer and the host metadata (epoch, hook scheduler states).
"""
from __future__ import annotations

import io
import os
import tempfile
from pathlib import Path
from typing import Any, Dict

import torch

from ..utils.utils import get_logger

logger = get_logger("checkpoint")


def safe_save(payload: bytes, path: str) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        os.replace(tmp, str(path))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """`state` holds state_dicts and plain python metadata."""
    buf = io.BytesIO()
    torch.save(state, buf)
    safe_save(buf.getvalue(), path)
    logger.debug("saved checkpoint to %s (%d bytes)", path, buf.tell())


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    return torch.load(path, map_location=map_location, weights_only=True)


def load_model_state_dict(path: str, map_location="cpu") -> Dict[str, torch.Tensor]:
    """Model-only warm start (reference utils.py:100-103
    extract_model_state_dict): the "_model" UNet state_dict of a checkpoint."""
    return load_checkpoint(path, map_location)["_model"]
