"""The control of each cell's check: the reference computed under bf16
autocast in the program's place (the precision below the configurations'
float32) comes out not correct against the float32 reference, by the
cell's own limits. On the chip, at the cells' own sizes, `portbench/
readings.py --control` reads it on a dozen seeds (PERF.md, PR 21); here it
runs at the tiny CPU size, on three seeds."""
import importlib
import os

import pytest

from portbench import compare, harness, manifest
from portbench.drivers.base import deep_merge
from portbench.tests import tiny

MAN = manifest.load()


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
@pytest.mark.parametrize("seed", [3, 4, 2 ** 31 + 5])
def test_the_control_is_not_correct(workload, seed, tmp_path):
    harness.keep_jax_out()
    entry = manifest.workload(MAN, workload)
    over = tiny.overrides(workload)
    config = deep_merge(manifest.config(MAN, entry["config"]), over["config"])
    traffic = deep_merge(manifest.traffic(entry["traffic"]), over["traffic"])
    driver = importlib.import_module(f"portbench.drivers.{config['driver']}")
    reference = importlib.import_module(f"portbench.reference.{config['reference']}")
    cell = driver.Cell(config, traffic, seed, "cpu", os.path.join(tmp_path, "run"))
    checked = cell.run_checked(int(traffic["check_steps"]))
    inputs, program = cell.reference_inputs(), cell.program
    cell.close()
    epoch = int(traffic["window_epoch"])
    ref = reference.follow(inputs, checked["feeds"], config, program, epoch, "float32", "cpu")
    low = reference.follow(inputs, checked["feeds"], config, program, epoch, "bfloat16", "cpu")
    limits = manifest.limits(workload)
    assert compare.judge(compare.gaps(checked, ref, inputs["weights"]), limits)[0]
    assert not compare.judge(compare.gaps(low, ref, inputs["weights"]), limits)[0]
