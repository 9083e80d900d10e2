"""Builds the port's CUDA sources at first use.

Each kernel is one file `csrc/<name>.cu` with a plain C interface, compiled
by `nvcc` for `sm_90a` into `_build/lib<name>-<hash>.so` (the hash covers the
source, the shared headers `csrc/*.cuh` and the flags, so an edit to any of
them rebuilds) and loaded with `ctypes` through `_native_build.library`,
which checks its per-process cache before it touches a file. `build_logs`
holds nvcc's stderr (the ptxas register/smem report).
`nvcc` is looked up on PATH, then under $CUDA_HOME (default /usr/local/cuda).
Each source has its own lock, so `load_all` runs one `nvcc` per source at
the same time. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

from ... import _native_build
from ..._native_build import CSRC_DIR, _libs, build_logs  # noqa: F401

# no -use_fast_math: __expf/__logf would move the 1/255 cutoff decisions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME: the CUDA kernels are "
        "built from csrc/ at first use and need the CUDA toolkit")


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu with nvcc; cached per
    process (the headers are read only when the cache misses)."""
    return _native_build.library(
        name, CSRC_DIR / f"{name}.cu", find_nvcc, NVCC_FLAGS,
        lambda: b"".join(h.read_bytes()
                         for h in sorted(CSRC_DIR.glob("*.cuh"))))


def load_all(names) -> dict:
    """Build and load several sources, one `nvcc` process each, all started
    together → {name: library}."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(load, names)))
