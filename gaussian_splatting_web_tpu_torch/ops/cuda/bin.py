"""Wrapper of binning's CUDA kernels for Hopper, `csrc/bin.cu`: the path
`ops/sort.py::bin_splats` takes for CUDA tensors with single-tier
duplication (`sort.takes_kernels`).

`bin_splats_cuda` returns the `TileBins` of `ops/sort.py::bin_splats_plain`
on the same tensors, bit for bit, every field included: a count pass (the
footprints, the shrink, the cull, each block's live slots per slot row),
one scan, one host read of the live-pair count M (`.item()`, binning's only
sync: it sizes the sort's buffers), an emit pass (the live (key, slot)
pairs in slot order, the dead slots straight into `sorted_slot`'s tail),
`cub::DeviceRadixSort` over the key's used bits and a ranges pass (tile
segments, `sorted_gidx`, `num_pairs` and `overflow` on the device, under
the gather cap). Slot ids are sorted as int32 while the frame has fewer
than 2³¹ slots, else as int64. Neither replaces a TPU kernel: the JAX
package bins with XLA. `launches` counts calls (one per binning) and is
changed nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...config import RenderConfig
from ...utils import tracing
from ..projection import ProjectedSplats
from ..sort import TileBins, gather_cap, sort_key_bits
from . import build
from .raster import _kernel_fn

launches = 0

PER_BLOCK = 1024        # Gaussians a block of the count and emit passes
INT32_SLOTS = 2 ** 31   # slot ids below this are sorted as int32


@functools.cache
def _fns():
    """The ctypes entries of csrc/bin.cu and its error-string function."""
    count, err_str = _kernel_fn("bin", 5, 11, 1, 5, entry="bin_count")
    emit, _ = _kernel_fn("bin", 4, 12, 0, 11, entry="bin_emit_sort")
    temp = build.load("bin").bin_sort_temp_bytes
    temp.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    temp.restype = ctypes.c_int
    return count, emit, temp, err_str


def _raise_on(err: int, entry: str, err_str) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} failed: cuda error {err} "
                           f"({err_str(err).decode()})")


def _field(t: torch.Tensor, name: str, dev, cols: int):
    """(tensor, row stride in elements) of a float32 [n] or [n, cols] field
    whose columns are contiguous (copied to make them so)."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if t.dim() != (2 if cols else 1) or (cols and t.shape[1] != cols):
        raise ValueError(f"{name} has shape {tuple(t.shape)}")
    if cols and t.stride(1) != 1:
        t = t.contiguous()
    return t, t.stride(0)


def bin_splats_cuda(splats: ProjectedSplats, width: int, height: int,
                    config: RenderConfig) -> TileBins:
    """`bin_splats` of CUDA-resident splats with single-tier duplication,
    through csrc/bin.cu; see the module docstring."""
    global launches
    gx, gy = config.grid_size(width, height)
    num_tiles = gx * gy
    n = splats.depth.shape[0]
    d = config.max_dup
    slots = n * d
    dev = splats.depth.device
    mean2d, s_mean = _field(splats.mean2d, "mean2d", dev, 2)
    conic, s_conic = _field(splats.conic, "conic", dev, 3)
    radius, s_radius = _field(splats.radius, "radius", dev, 0)
    opacity, s_opacity = _field(splats.opacity, "opacity", dev, 0)
    depth, s_depth = _field(splats.depth, "depth", dev, 0)
    valid = splats.valid.contiguous()
    if valid.dtype != torch.bool or tuple(valid.shape) != (n,):
        raise ValueError(f"valid must be a bool [{n}] array")
    blocks = -(-n // PER_BLOCK)
    i32, i64 = torch.int32, torch.int64

    def empty(*shape, dtype=i32):
        return torch.empty(shape, dtype=dtype, device=dev)

    geo = empty(n, 2)
    masks = empty(-(-d // 32), n)
    counts = empty(d + 1, blocks)
    offsets = empty(d * blocks + d, dtype=i64)   # in-row offsets, row totals
    meta = empty(4, dtype=i64)
    sorted_slot = empty(slots, dtype=i64)
    bounds = empty(num_tiles + 1)
    tile_start = empty(num_tiles)
    tile_count = empty(num_tiles)
    count_fn, emit_fn, temp_fn, err_str = _fns()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cull = config.tile_cull and config.radius_sigma <= 0
    _raise_on(count_fn(
        *(t.data_ptr() for t in (mean2d, conic, radius, opacity, valid)), n,
        d, gx, gy, config.tile_size, cull, config.radius_sigma > 0, s_mean,
        s_conic, s_radius, s_opacity, config.alpha_cutoff,
        *(t.data_ptr() for t in (geo, masks, counts, offsets, meta)),
        dev.index, stream), "bin_count", err_str)
    m = int(meta[0].item())                  # binning's one host sync
    if m >= 2 ** 31:
        raise ValueError(f"{m} live pairs: the sort takes fewer than 2^31")

    shift = sort_key_bits(num_tiles, config) or 32
    end_bit = shift + num_tiles.bit_length()
    key64 = end_bit > 32 or shift >= 32
    val64 = slots >= INT32_SLOTS
    kept = min(m, gather_cap(n, slots, config))
    keys = empty(2, m, dtype=i64 if key64 else i32)
    vals = empty(2, m, dtype=i64 if val64 else i32)
    nbytes = ctypes.c_longlong()
    _raise_on(temp_fn(m, key64, val64, end_bit, ctypes.byref(nbytes)),
              "bin_sort_temp_bytes", err_str)
    temp = empty(max(nbytes.value, 1), dtype=torch.uint8)
    sorted_gidx = empty(kept)
    _raise_on(emit_fn(
        *(t.data_ptr() for t in (geo, masks, offsets, depth)), n, d, gx,
        num_tiles, shift, end_bit, key64, val64, m, kept, s_depth,
        temp.shape[0], keys[0].data_ptr(), keys[1].data_ptr(),
        vals[0].data_ptr(), vals[1].data_ptr(),
        *(t.data_ptr() for t in (temp, sorted_slot, sorted_gidx, bounds,
                                 tile_start, tile_count, meta)),
        dev.index, stream), "bin_emit_sort", err_str)
    launches += 1

    tracing.count("binning.live_pairs", kept)
    tracing.count("binning.slots", slots)
    return TileBins(sorted_gidx=sorted_gidx, sorted_slot=sorted_slot,
                    tile_start=tile_start, tile_count=tile_count,
                    num_pairs=meta[2], overflow=meta[3], tier_a_width=d)
