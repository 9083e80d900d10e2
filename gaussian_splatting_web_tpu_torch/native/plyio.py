"""ctypes binding of csrc/plyio.cpp, the threaded PLY record unpack (the
JAX package's `native/plyio.py`).

The library is built with the host compiler at first use
(`_native_build.load_host`), never at import time. `unpack_fields`
returns a dict of dense float32 columns, the output of the NumPy
structured-dtype path in `io/ply.py`, in one threaded pass over the
record blob.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Tuple

import numpy as np

from .. import _native_build

_PROP_TYPE_CODE = {
    "float": 0, "float32": 0,
    "double": 1, "float64": 1,
    "uchar": 2, "uint8": 2,
    "char": 3, "int8": 3,
    "ushort": 4, "uint16": 4,
    "short": 5, "int16": 5,
    "uint": 6, "uint32": 6,
    "int": 7, "int32": 7,
}
_PROP_SIZE = {0: 4, 1: 8, 2: 1, 3: 1, 4: 2, 5: 2, 6: 4, 7: 4}


def _load() -> ctypes.CDLL:
    lib = _native_build.load_host("plyio")
    lib.ply_unpack.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.ply_unpack.restype = None
    return lib


def unpack_fields(
    body: bytes, properties: List[Tuple[str, str]], n: int
) -> Dict[str, np.ndarray]:
    """Decode n interleaved vertex records into {name: float32[n]} columns."""
    lib = _load()
    names = [p[0] for p in properties]
    codes = np.asarray([_PROP_TYPE_CODE[p[1]] for p in properties], np.int32)
    sizes = np.asarray([_PROP_SIZE[c] for c in codes], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    stride = int(sizes.sum())
    if len(body) < n * stride:
        raise ValueError(f"PLY body holds {len(body)} bytes, {n} records of "
                         f"{stride} need {n * stride}")

    buf = np.frombuffer(body, dtype=np.uint8, count=n * stride)
    out = np.empty((len(names), n), dtype=np.float32)
    nthreads = min(os.cpu_count() or 1, 8)
    lib.ply_unpack(
        buf.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n),
        ctypes.c_int64(stride),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(len(names)),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int32(nthreads),
    )
    return {name: out[i] for i, name in enumerate(names)}
