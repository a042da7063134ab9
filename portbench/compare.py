"""The comparison that decides `correct`: the program's checked steps
against the reference's, each number beside its limit.

- `loss_gap`: the widest relative gap of a checked step's loss (the sum of
  the losses the step returns) from the reference's.
- `grad_gap`: by the worst leaf, the gap between the norm of the first
  gradient as the optimizer took it and the reference's, over the larger
  of the reference's norm of that leaf and of the median leaf.
- `change_gap`: the same of the leaves' change over the checked steps (the
  EMA teacher's leaves too). Leaves whose first loss gradient in the
  reference is under a thousandth of the median leaf's are left out: they
  move by round-off alone.
- `grad_diff_median`, `change_diff_median`: by the median leaf, the norm
  of the difference over the same norms.
- `dice_gap` (steps that return per-slice Dice statistics of their
  prediction): the widest, over the checked steps, of the summed absolute
  differences of the intersections and unions over the reference's summed
  unions, about the share of pixels whose predicted class moved.

A cell's `limits/<cell>.json` names the numbers it is held to.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keys,
               of_difference: bool = False):
    """Each leaf's gap over the larger of the reference's norm of the leaf and
    of the median leaf: the gap between the two norms, or the norm of the
    difference."""
    if not keys:
        return [float("nan")]
    rn = {k: _norm(ref[k]) for k in keys}
    med = float(np.median(list(rn.values())))
    if of_difference:
        return [_norm(prog[k].double() - ref[k].double()) / max(rn[k], med, 1e-30) for k in keys]
    return [abs(_norm(prog[k]) - rn[k]) / max(rn[k], med, 1e-30) for k in keys]


def gaps(program: Dict, reference: Dict, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    loss = 0.0
    for p, r in zip(program["losses"], reference["losses"]):
        total = sum(r.values())
        loss = max(loss, abs(sum(p[k] for k in r) - total) / max(abs(total), 1e-30))
    if len(program["losses"]) != len(reference["losses"]) or not all(
            np.isfinite(v) for step in program["losses"] for v in step.values()):
        loss = float("inf")
    grads = (program["first_grad"], reference["first_grad"], list(reference["first_grad"]))
    raw = {k: _norm(v) for k, v in reference["first_raw"].items()}
    med = float(np.median(list(raw.values())))
    kept = [k for k in reference["after"]
            if raw[k.split("teacher.", 1)[-1]] >= 1e-3 * med]
    changes = ({k: program["after"][k] - start[k.split("teacher.", 1)[-1]] for k in kept},
               {k: reference["after"][k] - start[k.split("teacher.", 1)[-1]] for k in kept}, kept)
    out = {"loss_gap": loss, "grad_gap": max(_leaf_gaps(*grads)),
           "change_gap": max(_leaf_gaps(*changes))}
    if program.get("answers") and reference.get("answers") and reference["answers"][0]:
        out["dice_gap"] = max(
            sum(float((p[k] - r[k]).abs().sum()) for k in r) / float(r["union"].sum())
            for p, r in zip(program["answers"], reference["answers"]))
    for name, args in (("grad", grads), ("change", changes)):
        out[f"{name}_diff_median"] = float(np.median(_leaf_gaps(*args, of_difference=True)))
    return out


def judge(values: Dict[str, float], limits: Dict[str, Dict]) -> Tuple[bool, Dict]:
    """(correct, {name: {"value", "limit"}}): every number the cell's limits
    name within its limit."""
    checks = {k: {"value": values[k], "limit": lim["limit"]} for k, lim in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
