"""Wrappers of the anchor compositor's CUDA C++ kernels for Hopper:

  * kernel C, `csrc/anchor_fwd.cu`, merge and forward composite (replaces
    the TPU kernel `gaussian_splatting_web_tpu/ops/pallas/anchor.py::
    _fwd_kernel`);
  * kernel D, `csrc/anchor_bwd.cu`, its backward (replaces
    `gaussian_splatting_web_tpu/ops/pallas/anchor.py::_bwd_kernel`).

`composite_image_anchor` is the differentiable anchor compositor:
`AnchorCompositeFn` takes the packed per-splat fields [N, 12] to (rgb,
alpha) plus the per-pixel residual. A CUDA tensor runs C forward and D
backward, D reading the ordered lists C wrote; a CPU tensor runs the plain
PyTorch versions (`ops/anchor.py`) through the same Function; any other
device raises. Either way the backward folds the four row groups onto the
splats with `fold_anchor_grads`. `launches` and `launches_bwd` count
kernel launches and are changed nowhere else. `prepare_fwd` and
`prepare_bwd` do a launch's checks and allocations and return a callable
that only launches, so a kernel can be timed alone.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ...config import RenderConfig
from ..anchor import (
    KCL,
    AnchorBins,
    Merge,
    c_max,
    composite_anchor_backward_plain,
    composite_anchor_plain,
    fold_anchor_grads,
    k_cap,
)
from ..rasterize import FIELD_ROW, GRAD_ROW, Composite
from .raster import _check, _device_of, _kernel_fn

launches = 0       # kernel C
launches_bwd = 0   # kernel D

# kernel C's shared memory: the sort keys (8 bytes each, the union padded to
# a power of two) and the staged batch (256 pairs × 36 bytes), within the
# 227 KB a block may opt into on Hopper
STAGE_BYTES = 256 * 36
MAX_SMEM_BYTES = 232_448 - 16


def merge_smem_bytes(config: RenderConfig) -> int:
    """Dynamic shared memory kernel C needs for this config."""
    union = 2 * c_max(config) * KCL
    return (1 << (union - 1).bit_length()) * 8 + STAGE_BYTES


def _check_fields(fields, abins, config):
    """Checks shared by both kernels: tile size, field layout, entries."""
    if config.tile_size != 16:
        raise ValueError("the CUDA compositor is built for tile_size=16, "
                         f"got {config.tile_size}")
    _check(fields, "fields", torch.float32, fields.device, 2)
    if fields.shape[1] != FIELD_ROW or fields.data_ptr() % 16:
        raise ValueError(f"fields must be a 16-byte aligned [N, {FIELD_ROW}]"
                         f" array, got {tuple(fields.shape)}")
    _check(abins.sorted_gidx, "sorted_gidx", torch.int32, fields.device, 1)


def _check_inputs(fields, abins, width, height, config):
    """Kernel C's checks: the fields and the anchor bins."""
    _check_fields(fields, abins, config)
    dev = fields.device
    gx, gy = config.grid_size(width, height)
    m = abins.sorted_gidx.shape[0]
    for t, name, dtype in ((abins.sorted_meta, "sorted_meta", torch.uint8),
                           (abins.sorted_depth, "sorted_depth", torch.int32),
                           (abins.starts, "starts", torch.int32)):
        _check(t, name, dtype, dev, 1)
        if name != "starts" and t.shape[0] != m:
            raise ValueError(f"{name} holds {t.shape[0]} entries, not {m}")
    if abins.starts.shape[0] != gx * gy + 1:
        raise ValueError(f"starts holds {abins.starts.shape[0]} tiles + 1, "
                         f"the frame has {gx * gy}")
    s_end, gmin, gmax = torch.stack(
        [abins.starts[-1].to(torch.int64),
         abins.sorted_gidx.min().to(torch.int64),
         abins.sorted_gidx.max().to(torch.int64)]).tolist()
    if s_end > m or gmin < 0 or gmax >= fields.shape[0]:
        raise ValueError("anchor bins index outside the entry or splat arrays")
    return gx, gy


def prepare_fwd(fields, abins, width, height, config):
    """Kernel C's checks and outputs → (run, (Composite, Merge)): each run()
    launches C once over every tile of the frame into the outputs."""
    smem = merge_smem_bytes(config)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"max_per_tile={config.max_per_tile} needs {smem} bytes of shared "
            f"memory for kernel C's merge, more than the {MAX_SMEM_BYTES} a "
            "Hopper block can hold")
    gx, gy = _check_inputs(fields, abins, width, height, config)
    dev = fields.device
    kc = k_cap(config)
    out = Composite(
        rgb=torch.empty((height, width, 3), dtype=torch.float32, device=dev),
        alpha=torch.empty((height, width), dtype=torch.float32, device=dev),
        final_log_t=torch.empty((height, width), dtype=torch.float32,
                                device=dev),
        last_idx=torch.empty((height, width), dtype=torch.int32, device=dev))
    merge = Merge(
        ordered=torch.empty((gx * gy, kc), dtype=torch.int32, device=dev),
        k_used=torch.empty((gx * gy,), dtype=torch.int32, device=dev),
        group=torch.empty((gx * gy, kc), dtype=torch.int8, device=dev))
    ins = (fields, abins.sorted_gidx, abins.sorted_meta, abins.sorted_depth,
           abins.starts)
    fn, err_str = _kernel_fn("anchor_fwd", 5, 7, 3, 7)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        global launches
        err = fn(*(t.data_ptr() for t in ins),
                 width, height, gx, gy, c_max(config), kc, smem,
                 math.log(config.alpha_cutoff), config.alpha_max,
                 math.log(config.transmittance_eps),
                 *(t.data_ptr() for t in out + merge), dev.index, stream)
        if err != 0:
            raise RuntimeError(f"anchor_fwd launch failed: cuda error {err} "
                               f"({err_str(err).decode()})")
        launches += 1

    return run, (out, merge)


def _launch(fields, abins, width, height, config) -> Tuple[Composite, Merge]:
    """Kernel C over every tile of the frame."""
    run, out = prepare_fwd(fields, abins, width, height, config)
    run()
    return out


def composite_anchor(fields: torch.Tensor, abins: AnchorBins, width: int,
                     height: int, config: RenderConfig
                     ) -> Tuple[Composite, Merge]:
    """The anchor forward → (Composite, Merge): kernel C for CUDA tensors,
    the plain version for CPU tensors. Not differentiable; see
    `composite_image_anchor`."""
    if _device_of(fields) == "cpu":
        return composite_anchor_plain(fields, abins, width, height, config)
    return _launch(fields, abins, width, height, config)


def composite_anchor_backward(fields: torch.Tensor, abins: AnchorBins,
                              width: int, height: int, config: RenderConfig,
                              composite: Composite, merge: Merge,
                              d_rgb: torch.Tensor,
                              d_alpha: torch.Tensor) -> torch.Tensor:
    """Pair gradient rows [4, M, 9] (row group, sorted entry position) from
    the forward's residual and ordered lists and the image cotangents:
    kernel D for CUDA tensors, the plain version (which redoes the merge)
    for CPU tensors."""
    if _device_of(fields) == "cpu":
        return composite_anchor_backward_plain(
            fields, abins, width, height, config, composite, d_rgb, d_alpha)
    return _launch_bwd(fields, abins, width, height, config, composite,
                       merge, d_rgb, d_alpha)


def prepare_bwd(fields, abins, width, height, config, composite, merge,
                d_rgb, d_alpha):
    """Kernel D's checks and zeroed output → (run, dpairs): each run()
    launches D once over every tile of the frame into dpairs [4, M, 9]."""
    _check_fields(fields, abins, config)
    gx, gy = config.grid_size(width, height)
    dev = fields.device
    kc = k_cap(config)
    m = abins.sorted_gidx.shape[0]
    for t, name, dtype, shape in (
            (merge.ordered, "ordered", torch.int32, (gx * gy, kc)),
            (merge.k_used, "k_used", torch.int32, (gx * gy,)),
            (merge.group, "group", torch.int8, (gx * gy, kc)),
            (composite.final_log_t, "final_log_t", torch.float32,
             (height, width)),
            (composite.last_idx, "last_idx", torch.int32, (height, width)),
            (d_rgb, "d_rgb", torch.float32, (height, width, 3)),
            (d_alpha, "d_alpha", torch.float32, (height, width))):
        _check(t, name, dtype, dev, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    pmax, kmax = torch.stack([merge.ordered.max().to(torch.int64),
                              merge.k_used.max().to(torch.int64)]).tolist()
    if pmax >= m or kmax > kc:
        raise ValueError("ordered lists index outside the entries or k_cap")
    dpairs = torch.zeros((4, m, GRAD_ROW), dtype=torch.float32, device=dev)
    ins = (fields, abins.sorted_gidx, merge.ordered, merge.k_used,
           merge.group, composite.final_log_t, composite.last_idx, d_rgb,
           d_alpha)
    fn, err_str = _kernel_fn("anchor_bwd", 9, 6, 2, 1)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        global launches_bwd
        err = fn(*(t.data_ptr() for t in ins),
                 width, height, gx, gy, kc, m,
                 math.log(config.alpha_cutoff), config.alpha_max,
                 dpairs.data_ptr(), dev.index, stream)
        if err != 0:
            raise RuntimeError(f"anchor_bwd launch failed: cuda error {err} "
                               f"({err_str(err).decode()})")
        launches_bwd += 1

    return run, dpairs


def _launch_bwd(fields, abins, width, height, config, composite, merge,
                d_rgb, d_alpha) -> torch.Tensor:
    """Kernel D over every tile of the frame."""
    run, dpairs = prepare_bwd(fields, abins, width, height, config,
                              composite, merge, d_rgb, d_alpha)
    run()
    return dpairs


class AnchorCompositeFn(torch.autograd.Function):
    """fields [N, 12] → (rgb [H, W, 3], alpha [H, W], final_log_t,
    last_idx); the residual outputs carry no gradient. The backward
    returns the folded gradients widened to [N, 12] with zero pads."""

    @staticmethod
    def forward(ctx, fields, abins, width, height, config):
        out, merge = composite_anchor(fields, abins, width, height, config)
        ctx.mark_non_differentiable(out.final_log_t, out.last_idx)
        ctx.save_for_backward(fields, out.final_log_t, out.last_idx, *merge)
        ctx.frame = (abins, width, height, config)
        return tuple(out)

    @staticmethod
    def backward(ctx, d_rgb, d_alpha, _d_log_t, _d_last):
        fields, final_log_t, last_idx, *merge = ctx.saved_tensors
        abins, width, height, config = ctx.frame
        zero = fields.new_zeros((height, width))
        d_rgb = (zero[..., None].expand(height, width, 3) if d_rgb is None
                 else d_rgb).contiguous()
        d_alpha = (zero if d_alpha is None else d_alpha).contiguous()
        residual = Composite(None, None, final_log_t, last_idx)
        dpairs = composite_anchor_backward(fields, abins, width, height,
                                           config, residual, Merge(*merge),
                                           d_rgb, d_alpha)
        seg = fold_anchor_grads(dpairs, abins, fields.shape[0])
        return F.pad(seg, (0, FIELD_ROW - GRAD_ROW)), None, None, None, None


def composite_image_anchor(fields: torch.Tensor, abins: AnchorBins,
                           width: int, height: int,
                           config: RenderConfig) -> Composite:
    """Composite every tile of a width × height frame from the per-splat
    fields [N, 12] and the anchor bins → Composite (rgb, alpha,
    final_log_t, last_idx), differentiable in `fields`."""
    _device_of(fields)
    return Composite(*AnchorCompositeFn.apply(fields, abins, width, height,
                                              config))
