"""The plain reference against spcl_torch's steps at a tiny size on the CPU
(UNet-32 on 32-pixel crops, the same weights, batches and draws), through
the harness's whole run with the card's look skipped: each cell's checked
steps, window and comparison. Then the faults planted under the timed
path, each of which has to come out not correct.

On the CPU both sides compute in float32, so the losses agree to float
rounding. The first gradient and the change agree to a few parts in a
hundred at most: the zero fill of a rotated crop makes exactly tied
windows for the max pools, and a gradient routed to another member of a
tie moves the weight gradients by up to a few percent (a 5e-7 change of the
input does so on one and the same implementation).
"""
import io
import json

import pytest

from portbench import harness
from portbench.tests import tiny

CELLS = ("pretrain-2n60-nhwc", "semi-mt-b32-pallas", "pretrain-2n3840-gradcache")


def run(workload, fault=None, seed=2 ** 31 + 11):
    out, err = io.StringIO(), io.StringIO()
    result = harness.run_cell(workload, seed, 0.5, True, device="cpu",
                              overrides=tiny.overrides(workload), fault=fault, out=out, err=err)
    return result, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("workload", CELLS)
def test_reference_follows_the_program(workload):
    result, out, err = run(workload)
    checks = result["checks"]
    assert checks["loss_gap"]["value"] < 1e-5
    assert checks["grad_gap"]["value"] < 0.1
    assert checks["change_gap"]["value"] < 0.1
    assert result["failed"] == 0 and result["attempted"] > 5
    # the result is the last line of standard output, the checks come last in it
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device", "breakdown"}
    # each number compared beside its limit, the last lines of standard error
    tail = err.strip().splitlines()[-len(checks):]
    assert [t.split()[1] for t in tail] == list(checks)
    assert all(" limit " in t for t in tail)
    assert {"loss_gap", "grad_gap", "change_gap"} <= set(checks)


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in ("pretrain-2n60-nhwc", "semi-mt-b32-pallas") for f in ("frozen", "half",
                                                                           "altered")])
def test_faults_come_out_not_correct(workload, fault):
    """A step that leaves the state unchanged, half of each batch left out
    (the mean over the rest), a loss altered where it is produced: one of
    the numbers compared leaves its limit. One chip: no exchange to leave
    out."""
    result, _, _ = run(workload, fault)
    assert result["correct"] is False
