"""The readings that the limits of a cell's correctness check are set from
(PERF.md, "How the limits were set"), in one process:

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 [--control] \
        [--faults frozen,half,altered] [--out FILE]

For each seed: the program's checked steps against the float32 reference
(the lower reading); with `--control`, the reference computed under bf16
autocast against the float32 one (the control: the precision below the
configuration's float32); with `--faults`, the program with each fault of
`drivers/base.py::FAULTS` planted. One JSON line per reading. The window is
not run: the checked steps are the same call and feed as in `run.py`.
"""
import argparse
import gc
import importlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import compare, harness, manifest
    import torch
    harness.keep_jax_out()
    man = manifest.load()
    entry = manifest.workload(man, args.workload)
    config = manifest.config(man, entry["config"])
    traffic = manifest.traffic(entry["traffic"])
    driver = importlib.import_module(f"portbench.drivers.{config['driver']}")
    reference = importlib.import_module(f"portbench.reference.{config['reference']}")
    epoch, steps = int(traffic["window_epoch"]), int(traffic["check_steps"])
    out = open(args.out, "a") if args.out else None
    faults = [f for f in args.faults.split(",") if f]

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in [int(s) for s in args.seeds.split(",")]:
        for fault in [None] + faults:
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
                cell = driver.Cell(config, traffic, seed, args.device, os.path.join(tmp, "run"),
                                   fault=fault)
                checked = cell.run_checked(steps)
                inputs, program = cell.reference_inputs(), cell.program
                cell.close()
                del cell
                gc.collect()
                if args.device == "cuda":
                    torch.cuda.empty_cache()
                ref = reference.follow(inputs, checked["feeds"], config, program, epoch,
                                       "float32", args.device)
                emit({"workload": args.workload, "seed": seed, "side": fault or "program",
                      **compare.gaps(checked, ref, inputs["weights"]),
                      "losses": checked["losses"], "ref_losses": ref["losses"],
                      "seconds": time.perf_counter() - t0})
                if args.control and fault is None:
                    low = reference.follow(inputs, checked["feeds"], config, program, epoch,
                                           "bfloat16", args.device)
                    emit({"workload": args.workload, "seed": seed, "side": "control_bf16",
                          **compare.gaps(low, ref, inputs["weights"]),
                          "losses": low["losses"]})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
