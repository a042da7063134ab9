"""BENCHMARK.json against the benchmark's contract, the files it names, the
import guard, the refusal without a card, and a cell added by files and a
manifest entry alone."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness, manifest

ROOT = manifest.ROOT
MAN = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(MAN) == KEYS
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = [c["name"] for c in MAN["configs"]] + [w["name"] for w in MAN["workloads"]] \
        + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len({c["name"] for c in MAN["configs"]}) == len(MAN["configs"])
    assert len({w["name"] for w in MAN["workloads"]}) == len(MAN["workloads"])
    metric_names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_cell_finds_its_files():
    paths = [ROOT / p for p in MAN["paths"]]
    used = set()
    for w in MAN["workloads"]:
        cfg = manifest.config(MAN, w["config"])
        used.add(w["config"])
        entry = next(c for c in MAN["configs"] if c["name"] == w["config"])
        assert any(Path(ROOT / entry["file"]).resolve().is_relative_to(p) for p in paths)
        assert cfg["reduced"] == entry["reduced"] and cfg["name"] == w["config"]
        assert manifest.traffic(w["traffic"])["program"]
        limits = manifest.limits(w["name"])
        assert {"loss_gap", "grad_gap", "change_gap"} <= set(limits)
        for lim in limits.values():
            assert lim["lower"] < lim["limit"] < lim["upper"]
        for mod in ("drivers", "counts", "reference"):
            key = {"drivers": "driver", "counts": "counts", "reference": "reference"}[mod]
            assert (manifest.HERE / mod / f"{cfg[key]}.py").exists()
    assert used == {c["name"] for c in MAN["configs"]}
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert "def read(" in manifest.metric_file(m["name"]).read_text()


def test_moves_are_reported_by_each_cell():
    cells = [w["name"] for w in MAN["workloads"]]
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]]
    for cell in cells:
        reported = manifest.metrics(MAN, cell, False)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert manifest.metrics(MAN, cell, True)


def test_four_chip_cells_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(len(MAN["workloads"]) // 4, 1)


@pytest.mark.parametrize("loaded,found", [
    (["spcl_torch", "spcl_torch.models.unet", "numpy", "torch"], []),
    (["spcl_tpu.models.unet", "spcl_torch"], ["spcl_tpu"]),
    (["jax", "jax._src"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jax_extras", "spcl_tpu_tools", "flaxen"], []),
])
def test_import_guard_compares_whole_top_level_names(loaded, found):
    assert harness.forbidden_modules(loaded) == found


def test_the_program_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); from portbench import harness; "
            "harness.keep_jax_out(); import spcl_torch.entry, spcl_torch.training; "
            "from torch.utils.tensorboard import SummaryWriter; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stderr[-2000:]


def test_a_run_without_a_card_fails():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "pretrain-2n60-nhwc",
                          "--seed", "7", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_a_run_without_the_program_fails(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files:
    the run (its look for a card skipped) stops at the missing program."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in MAN["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import io; from portbench import harness; "
            "harness.run_cell('pretrain-2n60-nhwc', 7, 0.2, False, device='cpu', "
            "out=io.StringIO())")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "No module named 'spcl_torch'" in out.stderr


def test_a_cell_is_added_by_files_and_one_entry(tmp_path):
    """A new traffic mix and its limits, and one entry in BENCHMARK.json:
    the harness finds and runs the cell with no other file changed."""
    bench = tmp_path / "portbench"
    shutil.copytree(manifest.HERE, bench, ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "pretrain-2n30-nhwc", "config": "unet256-spinfonce-pretrain",
                             "traffic": "2n30-nhwc", "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    traffic = json.loads((bench / "traffic" / "2n60-nhwc.json").read_text())
    traffic["program"]["ContrastiveLoaderParams"]["scan_sample_num"] = 2
    traffic["program"]["Trainer"]["num_batches"] = 2
    (bench / "traffic" / "2n30-nhwc.json").write_text(json.dumps(traffic))
    shutil.copy(bench / "limits" / "pretrain-2n60-nhwc.json",
                bench / "limits" / "pretrain-2n30-nhwc.json")
    code = ("import sys, io; from portbench import harness; from portbench.tests import tiny; "
            "r = harness.run_cell('pretrain-2n30-nhwc', 5, 0.2, False, device='cpu', "
            "overrides={'config': tiny.CONFIG, 'traffic': {}}, out=io.StringIO(), "
            "err=io.StringIO()); print(r['correct'], r['checks']['loss_gap']['value'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"})
    assert out.returncode == 0, out.stderr[-3000:]
    correct, gap = out.stdout.strip().splitlines()[-1].split()
    assert correct == "True" and float(gap) < 1e-5
