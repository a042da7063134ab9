"""Hierarchical dictionary merge utilities.

Capability parity with reference contrastyou/configure/dictionary_utils.py:9-111:
recursive merge (later wins), a `remove` sentinel that deletes keys, anchor
extraction, and prefix extraction used to split one CLI into pretrain and
finetune configs (reference utils.py:7-34).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Mapping

REMOVE_SENTINEL = "remove"


def dictionary_merge_by_hierachy(base: Mapping, new: Mapping = None, deepcopy: bool = True) -> Dict:
    """Recursively merge `new` into `base`; values in `new` win; dicts merge by key."""
    if deepcopy:
        base = copy.deepcopy(dict(base))
    else:
        base = dict(base)
    if new is None:
        return base
    for k, v in new.items():
        if isinstance(v, Mapping) and isinstance(base.get(k), Mapping):
            base[k] = dictionary_merge_by_hierachy(base[k], v, deepcopy=deepcopy)
        else:
            base[k] = copy.deepcopy(v) if deepcopy else v
    return base


def remove_sentinel_keys(config: Mapping) -> Dict:
    """Drop every key whose value is the literal string ``"remove"``.

    Lets a CLI override delete a whole config block (and thereby
    deactivate the hook it would have enabled) — reference
    dictionary_utils.py:31-41 semantics.
    """
    out = {}
    for k, v in config.items():
        if isinstance(v, str) and v == REMOVE_SENTINEL:
            continue
        if isinstance(v, Mapping):
            out[k] = remove_sentinel_keys(v)
        else:
            out[k] = v
    return out


def extract_dictionary_from_anchor(config: Mapping, anchor: str) -> Dict[str, Any]:
    """Return the sub-dictionary rooted at dotted path `anchor` (empty if absent)."""
    node: Any = config
    for part in anchor.split("."):
        if not isinstance(node, Mapping) or part not in node:
            return {}
        node = node[part]
    return copy.deepcopy(node) if isinstance(node, Mapping) else {anchor.split(".")[-1]: node}


def extract_params_with_key_prefix(config: Mapping, prefix: str) -> Dict[str, Any]:
    """Collect keys starting with `prefix` (recursively), stripping the prefix.

    Used to split one merged CLI config into a pretrain config (``pre_``
    keys) and a finetune config (``ft_`` keys) — reference
    dictionary_utils.py:85-111 + utils.py:12-32.
    """
    out: Dict[str, Any] = {}
    for k, v in config.items():
        if isinstance(v, Mapping):
            sub = extract_params_with_key_prefix(v, prefix)
            if sub:
                out[k] = sub
        elif isinstance(k, str) and k.startswith(prefix):
            out[k[len(prefix):]] = v
    return out
