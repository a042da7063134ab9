"""Build-at-first-use for the CUDA kernels of `csrc/`: one shared library per
source file, compiled with nvcc for sm_90a, with a plain C interface that the
kernel modules bind with ctypes.

A library lands in `build/spcl_torch/` under a name keyed by the sha256 of its
source and flags, so an edited source rebuilds and concurrent builds never
see half a file (temp file + atomic replace). Nothing is built at import.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Tuple

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "spcl_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(source: Path, stem: str) -> Path:
    """The built library's path, keyed by the source and flags so that an
    edited source rebuilds."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def build_library(source: Path, stem: str, verbose: bool = False) -> Tuple[Path, float, str]:
    """Compile `source` with nvcc for sm_90a unless already built. Returns
    (library path, seconds spent compiling, compiler output); `verbose` adds
    ptxas' per-kernel register and shared-memory report to the output."""
    out = library_path(source, stem)
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(BUILD_DIR), suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) \
        + ["-o", tmp, str(source)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builds never see half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
