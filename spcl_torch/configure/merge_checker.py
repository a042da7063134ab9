"""Strict merge checking: reject CLI/opt keys absent from the base config.

Capability parity with reference contrastyou/configure/_merge_checker.py:17-34,
including the difflib "did you mean" suggestion.
"""
from __future__ import annotations

import difflib
from typing import List, Mapping


class UnknownKeyError(RuntimeError):
    pass


def _collect_paths(d: Mapping, prefix: str = "") -> List[str]:
    paths = []
    for k, v in d.items():
        p = f"{prefix}.{k}" if prefix else str(k)
        paths.append(p)
        if isinstance(v, Mapping):
            paths.extend(_collect_paths(v, p))
    return paths


def merge_checker(base_dictionary: Mapping, incoming_dictionary: Mapping) -> None:
    """Raise UnknownKeyError when `incoming_dictionary` introduces a key path
    that does not exist in `base_dictionary`, with a closest-match suggestion."""
    base_paths = set(_collect_paths(base_dictionary))
    for path in _collect_paths(incoming_dictionary):
        if path not in base_paths:
            suggestion = difflib.get_close_matches(path, base_paths, n=1)
            hint = f" Did you mean: {suggestion[0]!r}?" if suggestion else ""
            raise UnknownKeyError(f"unknown config key {path!r}.{hint}")
