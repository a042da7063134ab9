"""Epoch-summary display string (mytqdm parity).

The reference's custom tqdm logs one line per epoch with every meter value
(`contrastyou/mytqdm/mytqdm.py:38-57` + formatting in `mytqdm/utils.py`):
floats render as 3dp or scientific when tiny/huge, nested groups as
`name:[k:v, ...]`, and `_`-prefixed keys are pruned. This module reproduces
that formatting for the host epoch loop; there is no live progress bar —
steps are dispatched asynchronously, so per-epoch summary IS the rate
display here.
"""
from __future__ import annotations

import math
from typing import Any, Dict


def _fmt(v: Any) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return str(v)
    if math.isnan(f):
        return "nan"
    if f != 0.0 and (abs(f) < 0.01 or abs(f) >= 99):
        return f"{f:.2e}"
    return f"{f:.3f}"


def _dict2str(d: Dict) -> str:
    parts = []
    for k, v in d.items():
        if isinstance(k, str) and k.startswith("_"):
            continue
        if isinstance(v, dict):
            parts.append(f"{k}:[{_dict2str(v)}]")
        elif isinstance(v, (list, tuple)):
            parts.append(f"{k}:[" + ", ".join(_fmt(x) for x in v) + "]")
        else:
            parts.append(f"{k}:{_fmt(v)}")
    return ", ".join(parts)


def meter_display(group_dict: Dict) -> str:
    """{group: {meter: scalar-or-dict}} -> one pretty line."""
    return _dict2str(group_dict)
