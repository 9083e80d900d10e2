"""Builds the package's native sources (`csrc/`) at first use.

`library` compiles one source into `_build/lib<name>-<hash>.so` (the hash
covers the source, its dependencies and the flags, so an edit to any of them
rebuilds), loads it with `ctypes` and caches it per process. The cache is
checked first: a cached library costs one dict lookup, no file I/O. Each
name has its own lock, so several sources build at the same time. The CUDA
kernels build through `ops/cuda/build.py`; `load_host` builds the host C++
sources (the PLY unpack of `native/plyio.py`) with the host compiler.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable

_PKG = Path(__file__).resolve().parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")

_libs: dict = {}
_locks: dict = {}       # name → lock held while that source builds
_locks_lock = threading.Lock()
build_logs: dict = {}   # name → the compiler's stderr


def library(name: str, src: Path, compiler: Callable[[], str], flags,
            deps: Callable[[], bytes] = lambda: b"") -> ctypes.CDLL:
    """Build (if needed) and load `src` with `compiler()` and `flags`.
    `compiler` and `deps` are called only on a cache miss."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        digest = hashlib.sha256(
            src.read_bytes() + deps() + " ".join(flags).encode()
        ).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        if not so.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
            os.close(fd)
            try:
                proc = subprocess.run(
                    [compiler(), *flags, "-o", tmp, str(src)],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"failed to build {src.name}:\n{proc.stderr}")
                build_logs[name] = proc.stderr
                os.replace(tmp, so)   # atomic: concurrent builds agree
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib


def load_host(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the host C++ source csrc/<name>.cpp with
    $CXX (default g++); cached per process."""
    return library(name, CSRC_DIR / f"{name}.cpp",
                   lambda: os.environ.get("CXX", "g++"), CXX_FLAGS)
