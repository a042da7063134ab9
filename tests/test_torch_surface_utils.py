"""spcl_torch's host helpers, schedulers and package names against
spcl_tpu's, on the CPU.

- `LinearScheduler`, `ExpScheduler`, `InverseExpScheduler` and
  `WeightScheduler` equal spcl_tpu's to 1e-12 for epochs 0 .. max + 2, by
  `get_value` and by stepping; `state_dict` round-trips.
- `ramped_alpha` equals spcl_tpu's (float32).
- `nlist`, `path2Path`, `class_name`, `to_numpy`, `to_float`, `to_device`,
  `item2str`, `flatten_dict`, `ExceptionIgnorer` behave as spcl_tpu's; the
  storage and the writer use the shared `flatten_dict`.
- `DATA_PATH` / `OUTPUT_PATH` come from SPCL_DATA_PATH / SPCL_OUTPUT_PATH
  (set in a subprocess) with spcl_tpu's defaults.
- The names spcl_tpu's package `__init__`s export: the hook factories,
  `sharded_fused_self_paced_supcon`, `Trainer` (the base of every trainer).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spcl_torch
import spcl_tpu
from spcl_torch import schedulers as tsched
from spcl_torch import utils as tutils
from spcl_tpu import schedulers as jsched
from spcl_tpu import utils as jutils

ROOT = Path(__file__).resolve().parents[1]

SCHEDULERS = [("LinearScheduler", (10, 0.1, 2.0), {}),
              ("LinearScheduler", (7, 3.0, -1.0), {}),
              ("ExpScheduler", (10, 0.0, 1.0), {}),
              ("ExpScheduler", (6, 0.5, 4.0), {"p": 2.5}),
              ("InverseExpScheduler", (10, 0.0, 1.0), {}),
              ("InverseExpScheduler", (9, 2.0, 0.2), {"p": 0.7})]


@pytest.mark.parametrize("name,args,kwargs", SCHEDULERS,
                         ids=[f"{n}-{a[0]}" for n, a, _ in SCHEDULERS])
def test_schedulers_match_spcl_tpu(name, args, kwargs):
    ours, theirs = getattr(tsched, name)(*args, **kwargs), getattr(jsched, name)(*args, **kwargs)
    assert isinstance(ours, tsched.WeightScheduler)
    for epoch in range(args[0] + 3):
        assert abs(ours.get_value(epoch) - theirs.get_value(epoch)) <= 1e-12
        assert abs(ours.value - theirs.value) <= 1e-12
        ours.step()
        theirs.step()
    again = getattr(tsched, name)(*args, **kwargs)
    again.load_state_dict(ours.state_dict())
    assert again.epoch == ours.epoch == theirs.state_dict()["epoch"]
    assert again.value == ours.value


def test_weight_scheduler_is_the_base():
    for sched in (tsched, jsched):
        base = sched.WeightScheduler()
        with pytest.raises(NotImplementedError):
            base.get_value(0)
        for name in ("PScheduler", "RampScheduler", "LinearScheduler", "ExpScheduler",
                     "InverseExpScheduler"):
            assert issubclass(getattr(sched, name), sched.WeightScheduler)


def test_ramped_alpha_matches_spcl_tpu():
    from spcl_torch.models import ramped_alpha
    from spcl_tpu.models.ema import ramped_alpha as jax_ramped_alpha
    for step in (0, 1, 2, 3, 10, 999, 1000, 5000):
        for alpha_max in (0.999, 0.9):
            want = float(jax_ramped_alpha(jnp.asarray(step), alpha_max))
            assert ramped_alpha(step, alpha_max) == want


def test_small_helpers_match_spcl_tpu():
    for n, x in ((3, 1.5), (2, [4]), (2, ("a", "b")), (4, "s")):
        assert tutils.nlist(n)(x) == jutils.nlist(n)(x)
    with pytest.raises(ValueError):
        tutils.nlist(3)([1, 2])
    assert tutils.path2Path("a/b") == jutils.path2Path("a/b") == Path("a/b")
    p = Path("c")
    assert tutils.path2Path(p) is p
    assert tutils.class_name(torch.nn.Linear(1, 1)) == "Linear"
    item = {"loss": 0.25, "dsc": "0.5", 3: None}
    assert tutils.item2str(item) == jutils.item2str(item)


def test_to_numpy_and_to_float():
    t = torch.arange(6.0, requires_grad=True).reshape(2, 3) * 1.5
    np.testing.assert_array_equal(tutils.to_numpy(t), np.arange(6.0).reshape(2, 3) * 1.5)
    assert tutils.to_numpy([1, 2]).tolist() == [1, 2]
    for value in (torch.tensor(2.5), torch.tensor([[4.0, 1.0]]), np.float32(3.0), 7,
                  np.array([1.25, 2.0])):
        want = jutils.to_float(np.asarray(value))
        assert tutils.to_float(value) == want and isinstance(tutils.to_float(value), float)


def test_to_device_moves_nested_tensors():
    tree = {"a": torch.ones(2), "b": [torch.zeros(1, 3), (torch.arange(3), "tag")], "n": 4}
    moved = tutils.to_device(tree, "meta")
    assert moved["a"].device.type == "meta" and moved["a"].shape == (2,)
    assert isinstance(moved["b"], list) and moved["b"][0].device.type == "meta"
    assert isinstance(moved["b"][1], tuple) and moved["b"][1][0].device.type == "meta"
    assert moved["b"][1][1] == "tag" and moved["n"] == 4
    assert tree["a"].device.type == "cpu"  # the input is left as it was
    same = tutils.to_device(tree, "cpu")
    assert torch.equal(same["b"][1][0], tree["b"][1][0])


def test_flatten_dict_is_shared_and_matches_spcl_tpu():
    from spcl_torch import writer
    from spcl_torch.meters import storage
    nested = {"tra": {"loss": {"mean": 1.0, "std": 2}, "lr": 3e-4},
              "val": {"dsc": {"DSC1": 0.5}}, 7: "x"}
    assert tutils.flatten_dict(nested) == jutils.flatten_dict(nested)
    assert tutils.flatten_dict(nested, sep=".") == jutils.flatten_dict(nested, sep=".")
    assert storage.flatten_dict is tutils.flatten_dict is writer.flatten_dict
    s = storage.Storage()
    s.put_epoch(0, nested)
    assert s.history[0] == {"tra/loss/mean": 1.0, "tra/loss/std": 2, "tra/lr": 3e-4,
                            "val/dsc/DSC1": 0.5, "7": "x"}


def test_exception_ignorer_matches_spcl_tpu():
    for cls in (tutils.ExceptionIgnorer, jutils.ExceptionIgnorer):
        with cls(KeyError, ValueError):
            raise KeyError("k")
        with cls():
            raise RuntimeError("any Exception")
        with pytest.raises(TypeError):
            with cls(KeyError):
                raise TypeError("not listed")
        with pytest.raises(KeyboardInterrupt):
            with cls():
                raise KeyboardInterrupt
        with cls() as ignorer:
            pass
        assert isinstance(ignorer, cls)


def test_data_and_output_paths():
    assert spcl_torch.DATA_PATH == spcl_tpu.DATA_PATH or "SPCL_DATA_PATH" in os.environ
    assert spcl_torch.OUTPUT_PATH == spcl_tpu.OUTPUT_PATH or "SPCL_OUTPUT_PATH" in os.environ
    code = "import spcl_torch as s; print(s.DATA_PATH); print(s.OUTPUT_PATH)"
    env = {k: v for k, v in os.environ.items() if not k.startswith("SPCL_")}
    defaults = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=60, check=True)
    assert defaults.stdout.split() == [str(ROOT / ".data"), str(ROOT / "runs")]
    env.update(SPCL_DATA_PATH="/data/acdc", SPCL_OUTPUT_PATH="/out/runs")
    moved = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=60, check=True)
    assert moved.stdout.split() == ["/data/acdc", "/out/runs"]


def test_package_exports_of_spcl_tpu_names():
    from spcl_torch import hooks, ops, training
    from spcl_torch.hooks import creator
    from spcl_torch.ops import supcon_cuda
    for name in ("create_consistency_hook", "create_discrete_mi_consistency_hook",
                 "create_ent_min_hook", "create_midl_hook", "create_mine_hooks",
                 "create_mixup_hook", "create_mt_hook", "create_uc_mt_hook"):
        assert getattr(hooks, name) is getattr(creator, name) and name in hooks.__all__
    assert ops.sharded_fused_self_paced_supcon is supcon_cuda.sharded_fused_self_paced_supcon
    assert all(issubclass(cls, training.Trainer) for cls in training.trainer_zoo.values())
    assert "Trainer" in training.__all__
