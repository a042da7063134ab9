"""Host-side utilities: seeding, scalar-or-list broadcasting, yaml io, logging.

`fix_all_seed` pins python, numpy and torch. Randomness inside a training
step comes from explicit `torch.Generator`s owned by the trainer, not from
the global torch seed.
"""
from __future__ import annotations

import collections.abc
import logging
import random
import sys
from contextlib import contextmanager
from itertools import repeat
from pathlib import Path
from typing import Any, Dict, Union

import numpy as np
import torch

PathLike = Union[str, Path]


# ----------------------------------------------------------------------------- seeding
def fix_all_seed(seed: int) -> None:
    """Pin the host RNGs (python, numpy) and torch's default generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


@contextmanager
def fix_all_seed_within_context(seed: int):
    """Seed python + numpy inside the block, restoring their prior state on
    exit (the data splits draw from numpy's global RNG)."""
    py_state = random.getstate()
    np_state = np.random.get_state()
    random.seed(seed)
    np.random.seed(seed)
    try:
        yield
    finally:
        random.setstate(py_state)
        np.random.set_state(np_state)


# ----------------------------------------------------------------------------- broadcast helpers
def ntuple(n: int):
    """Broadcast a scalar (or check a length-n sequence) to an n-tuple; hook
    factories use it to broadcast per-feature hyperparameters."""

    def parse(x):
        if isinstance(x, str):
            return tuple(repeat(x, n))
        if isinstance(x, collections.abc.Iterable):
            x = tuple(x)
            if len(x) == 1:
                return tuple(repeat(x[0], n))
            if len(x) != n:
                raise ValueError(f"expected length {n}, got {len(x)}: {x}")
            return x
        return tuple(repeat(x, n))

    return parse


# ----------------------------------------------------------------------------- yaml io
def yaml_load(path: PathLike) -> Dict[str, Any]:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f) or {}


# ----------------------------------------------------------------------------- logging
_LOG_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s:%(lineno)d - %(message)s"


def config_logger(save_dir: PathLike = None, level: int = logging.INFO) -> logging.Logger:
    """Configure the package logger: stderr plus an optional per-run file."""
    root = logging.getLogger("spcl_torch")
    root.setLevel(logging.DEBUG)
    if not any(isinstance(h, logging.StreamHandler) and h.stream is sys.stderr
               for h in root.handlers):
        sh = logging.StreamHandler(sys.stderr)
        sh.setLevel(level)
        sh.setFormatter(logging.Formatter(_LOG_FORMAT))
        root.addHandler(sh)
    if save_dir is not None:
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(save_dir / "run.log")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(_LOG_FORMAT))
        root.addHandler(fh)
    return root


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"spcl_torch.{name}")
