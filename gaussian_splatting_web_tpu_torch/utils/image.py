"""PNG output with the standard library's zlib (no imaging package needed),
the encoder of the JAX package's `utils/image.py::_png_bytes`."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _png_bytes(arr: np.ndarray) -> bytes:
    """Minimal PNG encoder for uint8 [H, W, {1,3,4}] arrays."""
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def to_uint8(img) -> np.ndarray:
    """A float [0,1] or uint8 array (or CPU tensor) → uint8 NumPy array."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(img)


def write_png(img, path: str) -> None:
    """Write a float [0,1] or uint8 image to a PNG file."""
    with open(path, "wb") as f:
        f.write(_png_bytes(to_uint8(img)))


def encode_png(img) -> bytes:
    """Encode to PNG bytes (for the web viewer)."""
    return _png_bytes(to_uint8(img))
