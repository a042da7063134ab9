"""Ranks started by hand, one process per rank with the SPCL_* variables: the
port's counterpart of tests/test_multihost.py (ROADMAP A16).

Two processes of tests/torch_multihost_worker.py are started with
SPCL_COORDINATOR, SPCL_NUM_PROCESSES=2, SPCL_PROCESS_ID and the local
variables (SPCL_LOCAL_RANK, SPCL_LOCAL_WORLD_SIZE), as a user starts the
ranks of a run on its hosts, and one more with `--nprocs 1` alone, the
oracle. Each trains a pretrain pair, a fine-tune with eval and the same
fine-tune with `device_data: false` on the CPU under `Trainer.mesh: auto`.
Held:
- world 2 and 2 shards on both ranks: under `auto` a rank process trains
  its share of a 2-rank run, not the whole batch alone;
- the two ranks' losses and dice equal to rtol 1e-6;
- the ranks against the oracle at tests/test_torch_parallel_trainer.py's
  bounds: per-step losses and the best dice rtol 1e-5;
- the weights: each run's move of every tensor the optimizer holds (the
  worker's `moves`: norms and fixed random projections) equal between the
  ranks to rtol 1e-6, and within MOVES_RTOL of the oracle's. Measured on
  the CPU: one process alone at 2 or 4 threads against 1 moves 1.2e-5 -
  3.4e-5 apart, the ranks against the oracle 2.1e-5 - 6.9e-5; with the
  gradient all-reduce dropped, or averaged instead of summed, 0.35 - 0.68
  (and the losses 1.3e-3 - 1.4e-3 apart);
- `device_data: false` equal between the ranks and within [0, 1];
- files from process 0 only, none under process 1's directory.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from spcl_torch.parallel import mesh

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_multihost_worker.py"
WAIT_S = 240
MOVES_RTOL = 1e-3


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("SPCL_")}
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _apart(a, b) -> float:
    """Distance of two runs' `moves` relative to the second's size."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _record(log: Path):
    lines = log.read_text().strip().splitlines()
    return json.loads([line for line in lines if line.startswith("{")][-1])


def test_ranks_started_by_hand_match_one_process(tmp_path):
    port = mesh.free_port()
    starts = [(f"r{pid}", ["--nprocs", "2", "--outdir", str(tmp_path / "mh")],
               _env(**{mesh.ENV_COORDINATOR: f"localhost:{port}", mesh.ENV_NUM_PROCESSES: "2",
                       mesh.ENV_PROCESS_ID: str(pid), mesh.ENV_LOCAL_RANK: str(pid),
                       mesh.ENV_LOCAL_WORLD_SIZE: "2"}))
              for pid in range(2)]
    starts.append(("solo", ["--nprocs", "1", "--outdir", str(tmp_path / "solo")], _env()))
    procs, logs = {}, {}
    try:
        for name, args, env in starts:
            logs[name] = tmp_path / f"{name}.log"
            with open(logs[name], "w") as log:
                procs[name] = subprocess.Popen([sys.executable, str(WORKER), *args], env=env,
                                               cwd=str(ROOT), stdout=log,
                                               stderr=subprocess.STDOUT)
        for name, p in procs.items():
            assert p.wait(timeout=WAIT_S) == 0, \
                name + ":\n" + "\n".join(f"{n}: {logs[n].read_text()[-3000:]}" for n in logs)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    r0, r1, one = (_record(logs[n]) for n in ("r0", "r1", "solo"))

    # `mesh: auto` in a rank process is the run: 2 ranks, each on its rows
    assert (r0["world"], r1["world"], one["world"]) == (2, 2, 1)
    assert r0["n_shards"] == r1["n_shards"] == [2, 2, 2] and one["n_shards"] == [1, 1, 1]
    assert (r0["pid"], r1["pid"]) == (0, 1)
    assert r0["is_master"] and not r1["is_master"]

    # both processes compute the same global trajectory
    assert len(r0["pre_losses"]) == 8 and len(r0["ft_losses"]) == 8
    for key in ("pre_loss", "pre_losses", "ft_losses", "best_dice", "best_dice_stream"):
        np.testing.assert_allclose(r0[key], r1[key], rtol=1e-6, err_msg=key)
    assert 0.0 <= r0["best_dice_stream"] <= 1.0

    # ... and the single process's
    for key in ("pre_loss", "pre_losses", "ft_losses", "best_dice"):
        np.testing.assert_allclose(r0[key], one[key], rtol=1e-5, err_msg=key)

    # ... with the weights of the single process: the gradients were summed
    # over both ranks, once
    for run in ("pre", "ft", "ft_stream"):
        assert np.asarray(one["moves"][run])[:, 0].max() > 0, run
        np.testing.assert_allclose(r0["moves"][run], r1["moves"][run], rtol=1e-6, atol=0,
                                   err_msg=run)
        assert _apart(r0["moves"][run], one["moves"][run]) <= MOVES_RTOL, run

    # IO gating: process 0 wrote everything, process 1 nothing
    assert r0["pre_ckpt"] and r0["ft_best_ckpt"] and r0["csv"]
    assert not (r1["pre_ckpt"] or r1["ft_best_ckpt"] or r1["csv"])
    leftovers = [str(f) for f in (tmp_path / "mh" / "p1").rglob("*") if f.is_file()]
    assert not leftovers, leftovers
