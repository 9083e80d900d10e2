"""Wrappers of the tile compositor's CUDA C++ kernels for Hopper:

  * kernel A, `csrc/raster_fwd.cu`, the forward (replaces the TPU kernel
    `gaussian_splatting_web_tpu/ops/pallas/raster.py::_kernel`);
  * kernel B, `csrc/raster_bwd.cu`, its backward (replaces
    `gaussian_splatting_web_tpu/ops/pallas/raster_bwd.py::_bwd_kernel`).

`composite_image` is the differentiable compositor: `CompositeFn` takes the
packed per-splat fields [N, 12] to (rgb, alpha) plus the per-pixel
residual. A CUDA tensor runs A forward and B backward; a CPU tensor runs
the plain PyTorch twins (`ops/rasterize.py::composite_image_plain`,
`composite_backward_plain`) through the same Function; any other device
raises. Either way the backward folds B's pair rows onto the splats with
`fold_pair_grads`. `launches` and `launches_bwd` count kernel launches and
are changed nowhere else.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ...config import RenderConfig
from ..rasterize import (
    FIELD_ROW,
    GRAD_ROW,
    Composite,
    composite_backward_plain,
    composite_image_plain,
    fold_pair_grads,
)
from ..sort import TileBins
from . import build

launches = 0       # kernel A
launches_bwd = 0   # kernel B


def _kernel_fn(name: str, n_ptr_in: int, n_int: int, n_float: int,
               n_ptr_out: int):
    lib = build.load(name)
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr_in + [ctypes.c_int] * n_int
                   + [ctypes.c_float] * n_float + [ctypes.c_void_p] * n_ptr_out
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err_str = getattr(lib, f"{name}_error_string")
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return fn, err_str


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


def _check_inputs(fields, bins, width, height, config):
    """Checks shared by both kernels: tile size, field layout, bins."""
    if config.tile_size != 16:
        raise ValueError("the CUDA compositor is built for tile_size=16, "
                         f"got {config.tile_size}")
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
    return gx, gy


def _device_of(fields: torch.Tensor) -> str:
    if fields.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no compositor for device {fields.device}")
    return fields.device.type


def _forward(fields, bins, width, height, config) -> Composite:
    if _device_of(fields) == "cpu":
        return composite_image_plain(fields, bins, width, height, config)
    return _launch(fields, bins, width, height, config)


def _launch(fields, bins, width, height, config) -> Composite:
    """Kernel A over every tile of the frame."""
    global launches
    gx, gy = _check_inputs(fields, bins, width, height, config)
    dev = fields.device
    rgb = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    alpha = torch.empty((height, width), dtype=torch.float32, device=dev)
    final_log_t = torch.empty((height, width), dtype=torch.float32,
                              device=dev)
    last_idx = torch.empty((height, width), dtype=torch.int32, device=dev)

    fn, err_str = _kernel_fn("raster_fwd", 4, 5, 3, 4)
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


def composite_backward(fields: torch.Tensor, bins: TileBins, width: int,
                       height: int, config: RenderConfig,
                       composite: Composite, d_rgb: torch.Tensor,
                       d_alpha: torch.Tensor) -> torch.Tensor:
    """Per-pair gradient rows [M, 9] in sorted pair order from the forward's
    residual (`composite.final_log_t`, `composite.last_idx`) and the image
    cotangents d_rgb [H, W, 3], d_alpha [H, W]: kernel B for CUDA tensors,
    the plain twin for CPU tensors."""
    if _device_of(fields) == "cpu":
        return composite_backward_plain(fields, bins, width, height, config,
                                        composite, d_rgb, d_alpha)
    return _launch_bwd(fields, bins, width, height, config, composite,
                       d_rgb, d_alpha)


def _launch_bwd(fields, bins, width, height, config, composite, d_rgb,
                d_alpha) -> torch.Tensor:
    """Kernel B over every tile of the frame."""
    global launches_bwd
    gx, gy = _check_inputs(fields, bins, width, height, config)
    dev = fields.device
    _check(composite.final_log_t, "final_log_t", torch.float32, dev, 2)
    _check(composite.last_idx, "last_idx", torch.int32, dev, 2)
    _check(d_rgb, "d_rgb", torch.float32, dev, 3)
    _check(d_alpha, "d_alpha", torch.float32, dev, 2)
    for t, name in ((composite.final_log_t, "final_log_t"),
                    (composite.last_idx, "last_idx"), (d_rgb, "d_rgb"),
                    (d_alpha, "d_alpha")):
        if tuple(t.shape[:2]) != (height, width):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, the frame "
                             f"is {height}x{width}")
    if d_rgb.shape[2] != 3:
        raise ValueError(f"d_rgb has shape {tuple(d_rgb.shape)}")
    dpairs = torch.zeros((bins.sorted_gidx.shape[0], GRAD_ROW),
                         dtype=torch.float32, device=dev)

    fn, err_str = _kernel_fn("raster_bwd", 8, 5, 2, 1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(fields.data_ptr(), bins.sorted_gidx.data_ptr(),
             bins.tile_start.data_ptr(), bins.tile_count.data_ptr(),
             composite.final_log_t.data_ptr(), composite.last_idx.data_ptr(),
             d_rgb.data_ptr(), d_alpha.data_ptr(),
             width, height, gx, gy, config.max_per_tile,
             math.log(config.alpha_cutoff), config.alpha_max,
             dpairs.data_ptr(), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"raster_bwd launch failed: cuda error {err} "
                           f"({err_str(err).decode()})")
    launches_bwd += 1
    return dpairs


class CompositeFn(torch.autograd.Function):
    """fields [N, 12] → (rgb [H, W, 3], alpha [H, W], final_log_t,
    last_idx); the residual outputs carry no gradient. The backward
    returns the folded pair gradients widened to [N, 12] with zero pads."""

    @staticmethod
    def forward(ctx, fields, bins, width, height, config):
        out = _forward(fields, bins, width, height, config)
        ctx.mark_non_differentiable(out.final_log_t, out.last_idx)
        ctx.save_for_backward(fields, out.final_log_t, out.last_idx)
        ctx.frame = (bins, width, height, config)
        return tuple(out)

    @staticmethod
    def backward(ctx, d_rgb, d_alpha, _d_log_t, _d_last):
        fields, final_log_t, last_idx = ctx.saved_tensors
        bins, width, height, config = ctx.frame
        zero = fields.new_zeros((height, width))
        d_rgb = (zero[..., None].expand(height, width, 3) if d_rgb is None
                 else d_rgb).contiguous()
        d_alpha = (zero if d_alpha is None else d_alpha).contiguous()
        residual = Composite(None, None, final_log_t, last_idx)
        dpairs = composite_backward(fields, bins, width, height, config,
                                    residual, d_rgb, d_alpha)
        seg = fold_pair_grads(dpairs, bins, fields.shape[0])
        return F.pad(seg, (0, FIELD_ROW - GRAD_ROW)), None, None, None, None


def composite_image(fields: torch.Tensor, bins: TileBins, width: int,
                    height: int, config: RenderConfig) -> Composite:
    """Composite every tile of a width × height frame from the per-splat
    fields [N, 12] and the bins → Composite (rgb, alpha, final_log_t,
    last_idx), differentiable in `fields`."""
    _device_of(fields)
    return Composite(*CompositeFn.apply(fields, bins, width, height, config))
