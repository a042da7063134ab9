#!/usr/bin/env python
"""How far the semi step's gradients move under small perturbations, and
under faults of the stage backward: the yardstick of chip_smoke.py's
SEMI_GRAD_TOL.

    python3 scripts/measure_semi_grad_sensitivity.py

The step is chip_smoke.py's semi parity step (UNet-256 under
`small_c_layout="pallas"`, crop 32, 4 labeled + 4 unlabeled slices, mean
teacher + consistency, the same seeds), run on the CPU through the stage
kernels' plain versions. Printed, for each change against the unchanged step:
the largest and the median |g - g0| / |g0| (L2) over the parameters'
gradients, and the tensors that moved most. The changes:
- the weights multiplied by (1 + eps N(0, 1)), eps = 1e-7 and 1e-6: how far
  two float32 implementations may differ (max-pool and ReLU route by
  comparisons, so the gradients are not smooth at float32's scale);
- faults that a gradient check should catch: the skip cotangent `de` of the
  fused stages dropped, the dW of `dwprev` scaled by 1.1 and by 1.02.
"""
import copy
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from spcl_torch.data.augment import ACDC_LABEL  # noqa: E402
from spcl_torch.hooks import creator  # noqa: E402
from spcl_torch.models import EMATeacher, UNet  # noqa: E402
from spcl_torch.ops import convstage_cuda as cs  # noqa: E402
from spcl_torch.training import build_optimizer, build_semi_step, draw_semi_params  # noqa: E402


def _setup():
    torch.manual_seed(6)
    policy = dataclasses.replace(ACDC_LABEL, crop=32)
    rng = np.random.default_rng(12)
    n = 4
    lab = {"image": rng.integers(0, 255, (n, 1, 48, 48), dtype=np.uint8),
           "label": rng.integers(0, 4, (n, 48, 48), dtype=np.uint8),
           "valid": np.ones(n, np.float32)}
    unl = {"image": rng.integers(0, 255, (n, 1, 48, 48), dtype=np.uint8),
           "label": np.zeros((n, 48, 48), np.uint8),
           "partition": np.arange(n, dtype=np.int32) % 3, "patient": np.zeros(n, np.int32),
           "cycle": np.zeros(n, np.int32), "scan_idx": np.zeros(n, np.int32),
           "valid": np.array([1, 1, 1, 0], np.float32)}
    batches = [{k: torch.as_tensor(v) for k, v in b.items()} for b in (lab, unl)]
    draws = draw_semi_params(torch.Generator().manual_seed(14), *batches, None, policy=policy)
    base = UNet(max_channel=256, small_c_layout="pallas")
    return policy, batches, draws, base


def _grads(policy, batches, draws, base, eps=0.0):
    model = copy.deepcopy(base)
    if eps:
        gen = torch.Generator().manual_seed(99)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + eps * torch.randn(p.shape, generator=gen))
    teacher = EMATeacher(model)
    opt = build_optimizer(list(model.parameters()), lr=1e-4, weight_decay=1e-5)
    step = build_semi_step(model, [creator.create_consistency_hook(5.0),
                                   creator.create_mt_hook(10.0)], opt, num_classes=4,
                           policy=policy, teacher=teacher)
    step(*batches, None, {}, params=draws)
    return {k: p.grad.double().clone() for k, p in model.named_parameters()}


def _report(what, got, ref):
    rel = {k: float((got[k] - ref[k]).norm() / ref[k].norm()) for k in ref}
    vals = sorted(rel.values())
    worst = sorted(rel, key=rel.get)[-3:]
    print(f"{what:34s} L2 rel max {vals[-1]:.2e} median {vals[len(vals) // 2]:.2e}; "
          + ", ".join(f"{k} {rel[k]:.2e}" for k in worst), flush=True)


def main():
    setup = _setup()
    ref = _grads(*setup)
    for eps in (1e-7, 1e-6):
        _report(f"weights x (1 + {eps:g} N(0, 1))", _grads(*setup, eps=eps), ref)

    stage_backward, passes_for = cs.stage_backward, cs.passes_for

    def no_de(res, dp, de, external_first, plain=None):
        return stage_backward(res, dp, None if de is None else torch.zeros_like(de),
                              external_first, plain)

    cs.stage_backward = no_de
    try:
        _report("skip cotangent de dropped", _grads(*setup), ref)
    finally:
        cs.stage_backward = stage_backward

    def scaled(factor):
        def pf(z0, plain=None):
            ps = dict(passes_for(z0, plain))
            inner = ps["dwprev"]

            def dwprev(*args):
                dy0, dw1, sums = inner(*args)
                return dy0, dw1 * factor, sums
            ps["dwprev"] = dwprev
            return ps
        return pf

    for factor in (1.1, 1.02):
        cs.passes_for = scaled(factor)
        try:
            _report(f"dwprev dW x {factor}", _grads(*setup), ref)
        finally:
            cs.passes_for = passes_for


if __name__ == "__main__":
    main()
