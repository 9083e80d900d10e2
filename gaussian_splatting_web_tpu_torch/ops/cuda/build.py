"""Builds the port's CUDA sources at first use.

Each kernel is one file `csrc/<name>.cu` with a plain C interface, compiled
by `nvcc` for `sm_90a` into `_build/lib<name>-<hash>.so` (the hash covers the
source, the shared headers `csrc/*.cuh` and the flags, so an edit to any of
them rebuilds) and loaded with `ctypes` through `_native_build.library`,
which checks its per-process cache before it touches a file. `build_logs`
holds nvcc's stderr (the ptxas register/smem report).
`nvcc` is looked up on PATH, then under $CUDA_HOME (default /usr/local/cuda).
Each source has its own lock, so `load_all` runs one `nvcc` per source at
the same time.

Python reaches every kernel through this module's launcher: `KERNELS`
holds one `Kernel` handle for each launch entry of `csrc/*.cu` (every
`extern "C"` function but the `*_error_string`s and the host query
`bin_sort_temp_bytes`; `tests/test_torch_launcher.py` holds the table
against the sources). A handle loads its library and sets its argument
types on first use; a call appends the device index and the current
stream, raises on a nonzero return and counts the launch
(`launch_counts`, `reset_launches`). `check` is the wrappers' argument
check. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch

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


_ARGTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


class Kernel:
    """The launch entry `entry` of csrc/<lib>.cu. `layout` spells its
    arguments before the trailing (int device, void* stream) as runs of
    pointers, ints and floats: "5p 6i 3f 4p" is five pointers, six ints,
    three floats and four pointers. `name` is the count's key in
    `launch_counts` (None: not counted there). `launches` counts the
    successful calls."""

    __slots__ = ("lib", "entry", "layout", "name", "launches", "_fn", "_err")

    def __init__(self, lib: str, entry: str, layout: str, name):
        self.lib, self.entry, self.layout, self.name = lib, entry, layout, name
        self.launches = 0
        self._fn = self._err = None

    def kinds(self) -> str:
        """The layout as one letter an argument: "ppppp" "iiiiii" ..."""
        return "".join(int(run[:-1]) * run[-1] for run in self.layout.split())

    def _resolve(self):
        lib = load(self.lib)
        fn = getattr(lib, self.entry)
        fn.argtypes = ([_ARGTYPES[k] for k in self.kinds()]
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{self.lib}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        self._err, self._fn = err, fn
        return fn

    def describe(self, err: int) -> str:
        """The message of a nonzero return: the CUDA error and its string."""
        if self._err is None:
            self._resolve()
        return f"cuda error {err} ({self._err(err).decode()})"

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on `device`'s current stream with `args` (pointers as
        ints or None, then ints, then floats, as `layout` says)."""
        fn = self._fn or self._resolve()
        err = fn(*args, device.index,
                 torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"{self.entry} launch failed: "
                               f"{self.describe(err)}")
        self.launches += 1


KERNELS: Dict[str, Kernel] = {k.entry: k for k in (
    Kernel("raster_fwd", "raster_fwd", "5p 6i 3f 4p", "A"),
    Kernel("raster_bwd", "raster_bwd", "9p 6i 2f 1p", "B"),
    Kernel("anchor_fwd", "anchor_fwd", "6p 7i 3f 7p", "C"),
    Kernel("anchor_bwd", "anchor_bwd", "10p 6i 2f 1p", "D"),
    Kernel("raster_fwd", "raster_fwd_tiles", "6p 7i 3f 3p", "E-A"),
    Kernel("raster_bwd", "raster_bwd_tiles", "9p 7i 2f 1p", "E-B"),
    Kernel("project", "project_fwd", "6p 4i 5f 7p", "P"),
    Kernel("project", "project_bwd", "11p 4i 2f 5p", "P-bwd"),
    # binning's two passes count once, as its emit pass: one per binning
    Kernel("bin", "bin_count", "5p 11i 1f 5p", None),
    Kernel("bin", "bin_emit_sort", "4p 12i 11p", "bin"),
)}


def launch_counts() -> Dict[str, int]:
    """Launches since the last `reset_launches` by kernel: A, B, their
    tile-list entries E-A, E-B, C, D, the projection's P and P-bwd, and
    binning's calls (bin)."""
    return {k.name: k.launches for k in KERNELS.values() if k.name}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def check(t: torch.Tensor, name: str, dtype, device, ndim: int,
          contiguous: bool = True) -> None:
    """Raise unless `t` is an `ndim`-dim `dtype` tensor on `device`, and
    contiguous unless told otherwise."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {ndim} dims")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
