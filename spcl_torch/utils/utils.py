"""Host-side utilities: seeding, scalar-or-list broadcasting, yaml io, the
git hash, logging, and deepclustering2's small helpers (`path2Path`,
`class_name`, `to_numpy`, `to_float`, `to_device`, `item2str`,
`flatten_dict`, `ExceptionIgnorer`), as spcl_tpu's utils/utils.py has them.

`fix_all_seed` pins python, numpy and torch. Randomness inside a training
step comes from explicit `torch.Generator`s owned by the trainer, not from
the global torch seed.
"""
from __future__ import annotations

import collections.abc
import json
import logging
import random
import subprocess
import sys
from contextlib import contextmanager
from itertools import repeat
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Union

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


def nlist(n: int):
    """`ntuple` returning a list."""
    f = ntuple(n)

    def parse(x):
        return list(f(x))

    return parse


# ----------------------------------------------------------------------------- misc
def path2Path(path: PathLike) -> Path:
    return path if isinstance(path, Path) else Path(path)


def class_name(obj) -> str:
    return obj.__class__.__name__


def to_numpy(x) -> np.ndarray:
    """A tensor (any device, with or without grad) or array-like -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_float(x) -> float:
    """The first element of a tensor or array, or a scalar, as a float."""
    x = to_numpy(x)
    return float(x.reshape(-1)[0]) if x.ndim else float(x)


def to_device(x, device="cuda"):
    """Tensors, alone or in nested dicts, lists and tuples, moved with
    `.to(device)`; other leaves are returned as they are."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, Mapping):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, device) for v in x)
    return x


def item2str(item: Mapping) -> str:
    """dict -> 'k1:v1, k2:v2' (deepclustering2's progress-bar format)."""
    return ", ".join(f"{k}:{v}" for k, v in item.items())


def flatten_dict(d: Mapping, parent_key: str = "", sep: str = "/") -> Dict[str, Any]:
    """A nested dict -> `{a/b/c: leaf}` (the storage columns and the
    TensorBoard scalar tags)."""
    items = {}
    for k, v in d.items():
        new_key = f"{parent_key}{sep}{k}" if parent_key else str(k)
        if isinstance(v, Mapping):
            items.update(flatten_dict(v, new_key, sep=sep))
        else:
            items[new_key] = v
    return items


class ExceptionIgnorer:
    """A context manager that swallows the given exception types (all
    `Exception`s when none are given)."""

    def __init__(self, *exceptions):
        self._exceptions = exceptions or (Exception,)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return exc_type is not None and issubclass(exc_type, self._exceptions)


# ----------------------------------------------------------------------------- yaml io
def yaml_load(path: PathLike) -> Dict[str, Any]:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f) or {}


def yaml_write(dictionary: Mapping, save_dir: PathLike, save_name: str) -> str:
    """Write `dictionary` as YAML to save_dir/save_name (spcl_tpu
    utils/utils.py:99-105: numpy scalars and arrays as plain values, tuples
    as lists, keys in their order). Without pyyaml the file is written as
    JSON, which is valid YAML and loads to the same dict. Returns the path."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    out = save_dir / save_name
    plain = _to_plain(dictionary)
    try:
        import yaml
    except ImportError:
        yaml = None
    with open(out, "w") as f:
        if yaml is not None:
            yaml.safe_dump(plain, f, sort_keys=False)
        else:
            json.dump(plain, f, indent=2)
            f.write("\n")
    return str(out)


def _to_plain(obj):
    if isinstance(obj, Mapping):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def gethash(repo_dir: PathLike = None) -> Optional[str]:
    """The git commit of the checkout (spcl_tpu utils/utils.py:119-128), or
    None outside a git repository; written beside each run's config."""
    cwd = str(Path(repo_dir) if repo_dir is not None else Path(__file__).parents[2])
    try:
        return subprocess.check_output(["git", "rev-parse", "HEAD"], cwd=cwd,
                                       stderr=subprocess.DEVNULL).decode().strip()
    except Exception:
        return None


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
