"""Builds the port's CUDA sources at first use.

Each kernel is one file `csrc/<name>.cu` with a plain C interface, compiled
by `nvcc` for `sm_90a` into `_build/lib<name>-<hash>.so` (the hash covers the
source and the flags, so an edit rebuilds) and loaded with `ctypes`.
`nvcc` is looked up on PATH, then under $CUDA_HOME (default /usr/local/cuda).
Each source has its own lock, so `load_all` runs one `nvcc` per source at
the same time. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# no -use_fast_math: __expf/__logf would move the 1/255 cutoff decisions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
_locks: dict = {}       # name → lock held while that source builds
_locks_lock = threading.Lock()
build_logs: dict = {}   # name → nvcc's stderr (ptxas register/smem report)


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME: the CUDA kernels are "
        "built from csrc/ at first use and need the CUDA toolkit")


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        src = CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        if not so.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
            os.close(fd)
            try:
                proc = subprocess.run(
                    [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed to build {src.name}:\n{proc.stderr}")
                build_logs[name] = proc.stderr
                os.replace(tmp, so)   # atomic: concurrent builds agree
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib


def load_all(names) -> dict:
    """Build and load several sources, one `nvcc` process each, all started
    together → {name: library}."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(load, names)))
