"""Vectorized PLY reader/writer for 3D Gaussian splat checkpoints, the
NumPy path of the JAX package's `io/ply.py` (the `native/plyio` fast path
is ROADMAP §1 item 9).

Semantics reproduced from the reference (src/ply.ts): binary little-endian
`element vertex N` bodies, uchar properties scaled by 1/255, SH degree from
the `f_rest_*` count, f_dc then colour-major f_rest coefficients into
[N, K, 3], rotations read as (w, x, y, z) and stored normalized as
(x, y, z, w) with non-finite components zeroed, scales kept in log space.
"""

from __future__ import annotations

import dataclasses
import os
import re
import types
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.types import GaussianCloud

_PLY_TYPES: Dict[str, np.dtype] = {
    "float": np.dtype("<f4"),
    "float32": np.dtype("<f4"),
    "double": np.dtype("<f8"),
    "float64": np.dtype("<f8"),
    "uchar": np.dtype("<u1"),
    "uint8": np.dtype("<u1"),
    "char": np.dtype("<i1"),
    "int8": np.dtype("<i1"),
    "ushort": np.dtype("<u2"),
    "uint16": np.dtype("<u2"),
    "short": np.dtype("<i2"),
    "int16": np.dtype("<i2"),
    "uint": np.dtype("<u4"),
    "uint32": np.dtype("<u4"),
    "int": np.dtype("<i4"),
    "int32": np.dtype("<i4"),
}


@dataclasses.dataclass
class PlyHeader:
    vertex_count: int
    properties: List[Tuple[str, str]]  # (name, ply type)
    body_offset: int
    sh_degree: int
    n_sh_coeffs: int


def n_sh_coeffs(degree: int) -> int:
    """ref ply.ts:130-143."""
    try:
        return {0: 1, 1: 4, 2: 9, 3: 16}[degree]
    except KeyError:
        raise ValueError(f"Unsupported SH degree: {degree}")


def _parse_header(data: bytes) -> PlyHeader:
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError("not a PLY file: no end_header")
    body_offset = data.find(b"\n", end) + 1
    header_text = data[:end].decode("ascii", errors="replace")
    lines = [ln.strip() for ln in header_text.split("\n")]

    if not lines or lines[0] != "ply":
        raise ValueError("not a PLY file: missing 'ply' magic")
    fmt = next((ln for ln in lines if ln.startswith("format")), "")
    if "binary_little_endian" not in fmt:
        raise ValueError(f"unsupported PLY format: {fmt!r} "
                         "(only binary_little_endian, like the reference)")

    vertex_count = 0
    properties: List[Tuple[str, str]] = []
    in_vertex_element = False
    for ln in lines:
        if ln.startswith("element"):
            m = re.match(r"element\s+(\w+)\s+(\d+)", ln)
            in_vertex_element = bool(m and m.group(1) == "vertex")
            if in_vertex_element:
                vertex_count = int(m.group(2))
        elif ln.startswith("property") and in_vertex_element:
            m = re.match(r"property\s+(\w+)\s+(\w+)", ln)
            if m:
                ptype, pname = m.group(1), m.group(2)
                if ptype == "list":
                    raise ValueError("list properties unsupported in vertex element")
                properties.append((pname, ptype))

    n_rest = sum(1 for name, _ in properties if name.startswith("f_rest_"))
    n_per_color = n_rest // 3
    degree = int(round(np.sqrt(n_per_color + 1) - 1))  # ply.ts:234
    if n_sh_coeffs(degree) - 1 != n_per_color:
        raise ValueError(f"inconsistent f_rest count {n_rest}")

    return PlyHeader(
        vertex_count=vertex_count,
        properties=properties,
        body_offset=body_offset,
        sh_degree=degree,
        n_sh_coeffs=n_sh_coeffs(degree),
    )


def _read_bytes(path_or_bytes, progress) -> bytes:
    if isinstance(path_or_bytes, (str, os.PathLike)):
        total = os.path.getsize(path_or_bytes)
        with open(path_or_bytes, "rb") as f:
            if progress is None:
                return f.read()
            chunks = []
            got = 0
            while chunk := f.read(1 << 24):
                chunks.append(chunk)
                got += len(chunk)
                progress(got, total)
            return b"".join(chunks)
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        return bytes(path_or_bytes)
    return path_or_bytes.read()


def read_ply(
    path_or_bytes,
    progress: Optional[Callable[[int, int], None]] = None,
    device="cpu",
) -> GaussianCloud:
    """Read an INRIA-style Gaussian-splat PLY (path, bytes or file-like)
    into a GaussianCloud on `device`. `progress(bytes_read, total)` is
    called while a path is read."""
    data = _read_bytes(path_or_bytes, progress)
    header = _parse_header(data)
    props = dict(header.properties)
    dtype = np.dtype([(name, _PLY_TYPES[ptype])
                      for name, ptype in header.properties])
    n = header.vertex_count
    body = data[header.body_offset: header.body_offset + n * dtype.itemsize]
    if len(body) < n * dtype.itemsize:
        raise ValueError(
            f"PLY body truncated: need {n * dtype.itemsize} bytes, got {len(body)}"
        )
    rec = np.frombuffer(body, dtype=dtype, count=n)

    def col(name):
        v = rec[name].astype(np.float32)
        if props[name] in ("uchar", "uint8"):
            v = v / 255.0  # ply.ts:122
        return v

    xyz = np.stack([col(c) for c in ("x", "y", "z")], axis=1)
    log_scale = np.stack([col(f"scale_{i}") for i in range(3)], axis=1)

    # quaternion: PLY order (w,x,y,z) → (x,y,z,w); normalize; NaN→0.
    q_wxyz = np.stack([col(f"rot_{i}") for i in range(4)], axis=1)
    q = q_wxyz[:, [1, 2, 3, 0]]
    norm = np.linalg.norm(q, axis=1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        q = q / norm
    q = np.nan_to_num(q, nan=0.0, posinf=0.0, neginf=0.0)  # ply.ts:293-296

    # SH: f_dc then f_rest colour-major interleave (ply.ts:238-246)
    k = header.n_sh_coeffs
    n_per_color = k - 1
    sh = np.empty((n, k, 3), dtype=np.float32)
    for rgb in range(3):
        sh[:, 0, rgb] = col(f"f_dc_{rgb}")
    for i in range(n_per_color):
        for rgb in range(3):
            sh[:, 1 + i, rgb] = col(f"f_rest_{rgb * n_per_color + i}")

    arrays = types.SimpleNamespace(xyz=xyz, log_scale=log_scale, quat=q,
                                   opacity_logit=col("opacity"), sh=sh)
    return GaussianCloud.from_numpy(arrays, device=device)


def write_ply(cloud: GaussianCloud, path_or_file) -> None:
    """Write a GaussianCloud as an INRIA-layout binary PLY: quaternions in
    PLY (w,x,y,z) order, log scales, zero normals."""
    a = cloud.to_numpy()
    xyz, sh, q = a["xyz"], a["sh"], a["quat"]
    n, k, _ = sh.shape
    n_per_color = k - 1

    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * n_per_color)]
    names += ["opacity"] + [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]

    rec = np.zeros(n, dtype=np.dtype([(nm, "<f4") for nm in names]))
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    for rgb in range(3):
        rec[f"f_dc_{rgb}"] = sh[:, 0, rgb]
    for i in range(n_per_color):
        for rgb in range(3):
            rec[f"f_rest_{rgb * n_per_color + i}"] = sh[:, 1 + i, rgb]
    rec["opacity"] = a["opacity_logit"]
    for i in range(3):
        rec[f"scale_{i}"] = a["log_scale"][:, i]
    q_wxyz = q[:, [3, 0, 1, 2]]                     # (x,y,z,w) → (w,x,y,z)
    for i in range(4):
        rec[f"rot_{i}"] = q_wxyz[:, i]

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {nm}" for nm in names]
    header += ["end_header", ""]
    blob = "\n".join(header).encode("ascii") + rec.tobytes()

    if isinstance(path_or_file, (str, os.PathLike)):
        with open(path_or_file, "wb") as f:
            f.write(blob)
    else:
        path_or_file.write(blob)
