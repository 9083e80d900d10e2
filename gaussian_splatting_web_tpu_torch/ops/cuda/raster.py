"""Wrapper of kernel A, the forward tile compositor written in CUDA C++
for Hopper (`csrc/raster_fwd.cu`; replaces the TPU kernel
`gaussian_splatting_web_tpu/ops/pallas/raster.py::_kernel`).

`composite_image` takes a CPU tensor to the plain PyTorch twin
(`ops/rasterize.py::composite_image_plain`) and a CUDA tensor to the
kernel; any other device raises. The CUDA path is forward-only: an input
that requires grad raises (the backward kernel is ROADMAP §1 item 6).
`launches` counts kernel launches; it is changed nowhere else.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...config import RenderConfig
from ..rasterize import FIELD_ROW, Composite, composite_image_plain
from ..sort import TileBins
from . import build

launches = 0


def _kernel_fn():
    lib = build.load("raster_fwd")
    fn = lib.raster_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.raster_fwd_error_string.argtypes = [ctypes.c_int]
    lib.raster_fwd_error_string.restype = ctypes.c_char_p
    return fn, lib.raster_fwd_error_string


def _check(t: torch.Tensor, name: str, dtype, device, ndim: int):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def composite_image(fields: torch.Tensor, bins: TileBins, width: int,
                    height: int, config: RenderConfig) -> Composite:
    """Composite every tile of a width × height frame from the per-splat
    fields [N, 12] and the bins → Composite (rgb, alpha, final_log_t,
    last_idx)."""
    if fields.device.type == "cpu":
        return composite_image_plain(fields, bins, width, height, config)
    if fields.device.type != "cuda":
        raise ValueError(f"no compositor for device {fields.device}")
    return _launch(fields, bins, width, height, config)


def _launch(fields, bins, width, height, config) -> Composite:
    global launches
    if config.tile_size != 16:
        raise ValueError("the CUDA compositor is built for tile_size=16, "
                         f"got {config.tile_size}")
    if fields.requires_grad:
        raise RuntimeError(
            "the CUDA compositor is forward-only (its backward kernel is "
            "ROADMAP §1 item 6): render under torch.no_grad() or detach")
    dev = fields.device
    gx, gy = config.grid_size(width, height)
    _check(fields, "fields", torch.float32, dev, 2)
    if fields.shape[1] != FIELD_ROW or fields.data_ptr() % 16:
        raise ValueError(f"fields must be a 16-byte aligned [N, {FIELD_ROW}]"
                         f" array, got {tuple(fields.shape)}")
    _check(bins.sorted_gidx, "sorted_gidx", torch.int32, dev, 1)
    _check(bins.tile_start, "tile_start", torch.int32, dev, 1)
    _check(bins.tile_count, "tile_count", torch.int32, dev, 1)
    if bins.tile_start.shape[0] != gx * gy or \
            bins.tile_count.shape[0] != gx * gy:
        raise ValueError(f"bins hold {bins.tile_start.shape[0]} tiles, "
                         f"the frame has {gx * gy}")
    m = bins.sorted_gidx.shape[0]
    if m:
        seg_end = (bins.tile_start.to(torch.int64)
                   + torch.clamp(bins.tile_count, max=config.max_per_tile))
        end, gmin, gmax = torch.stack(
            [seg_end.max(), bins.sorted_gidx.min().to(torch.int64),
             bins.sorted_gidx.max().to(torch.int64)]).tolist()
        if end > m or gmin < 0 or gmax >= fields.shape[0]:
            raise ValueError("bins index outside the pair or splat arrays")

    rgb = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    alpha = torch.empty((height, width), dtype=torch.float32, device=dev)
    final_log_t = torch.empty((height, width), dtype=torch.float32,
                              device=dev)
    last_idx = torch.empty((height, width), dtype=torch.int32, device=dev)

    fn, err_str = _kernel_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(fields.data_ptr(), bins.sorted_gidx.data_ptr(),
             bins.tile_start.data_ptr(), bins.tile_count.data_ptr(),
             width, height, gx, gy, config.max_per_tile,
             math.log(config.alpha_cutoff), config.alpha_max,
             math.log(config.transmittance_eps),
             rgb.data_ptr(), alpha.data_ptr(), final_log_t.data_ptr(),
             last_idx.data_ptr(), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"raster_fwd launch failed: cuda error {err} "
                           f"({err_str(err).decode()})")
    launches += 1
    return Composite(rgb=rgb, alpha=alpha, final_log_t=final_log_t,
                     last_idx=last_idx)
