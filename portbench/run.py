"""Run one cell of the benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints each number of the correctness check
beside its limit as the last lines of standard error, and the result as one
JSON line, the last of standard output. Exits 2, printing no result, where
there is no CUDA card or fewer than the cell asks for; 3 where JAX or the
JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"


def _fixed_caches() -> None:
    """Every kernel cache inside the checkout, at a fixed path (the
    program builds its own libraries under build/spcl_torch)."""
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()
    sys.path.insert(0, str(ROOT))
    from portbench import harness, manifest
    harness.keep_jax_out()
    chips = int(manifest.workload(manifest.load(), args.workload)["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                     device="cuda", t_start=T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
