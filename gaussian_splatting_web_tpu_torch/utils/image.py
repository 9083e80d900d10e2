"""PNG encode and decode with the standard library's zlib (no imaging
package needed): the encoder of the JAX package's
`utils/image.py::_png_bytes`, and a decoder for the training images.
`read_image` reads any format through pillow, imported when called."""

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


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth)
    of [H, 1 + stride] uint8 rows → [H, stride] uint8."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind == 1:
            # recon[x] = line[x] + recon[x − bpp]: a running sum per channel
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0) & 0xFF).reshape(-1)
        elif kind in (3, 4):
            cur = np.zeros(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x0 in range(0, stride, bpp):
                up = prev[x0:x0 + bpp]
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - up_left
                    pa, pb, pc = np.abs(p - left), np.abs(p - up), \
                        np.abs(p - up_left)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, up_left))
                left = (line[x0:x0 + bpp] + pred) & 0xFF
                cur[x0:x0 + bpp] = left
                up_left = up
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path_or_bytes) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG (grey, grey+alpha, RGB or RGBA;
    every row filter) with the standard library's zlib → uint8 [H, W, C]."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = hdr
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(color_type)
    if depth != 8 or channels is None or interlace:
        raise NotImplementedError(
            f"PNG with bit depth {depth}, colour type {color_type}, "
            f"interlace {interlace}: only 8-bit non-interlaced grey, "
            "grey+alpha, RGB and RGBA are decoded")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw[:h * (1 + w * channels)].reshape(h, 1 + w * channels)
    return _unfilter(rows, channels).reshape(h, w, channels)


def read_image(path: str) -> np.ndarray:
    """Read an image to float32 [0, 1] [H, W, 3] (JAX `utils/image.py::
    read_image`)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
