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
device raises. Either way the backward (`raster.field_grads`, in the span
`composite_bwd`) folds the four row groups onto the splats with
`fold_anchor_grads`. `prepare_fwd` and `prepare_bwd` do a launch's checks
and allocations and return a callable that only launches (through
`build.KERNELS`), so a kernel can be timed alone. Both kernels share A's
and B's walks (`csrc/tile_walk.cuh`) and run the tiles heavy first
(`csrc/tile_order.cuh`; the plain twins are `tile_order` for C, by
`schedule_weight`, and `raster.heavy_first_order` over `k_used` for D).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ...config import RenderConfig
from ...utils import tracing
from ..anchor import (
    KCL,
    AnchorBins,
    Merge,
    c_max,
    composite_anchor_backward_plain,
    composite_anchor_plain,
    cover_lengths,
    fold_anchor_grads,
    k_cap,
)
from ..rasterize import GRAD_ROW, Composite
from . import runs_kernels
from .build import KERNELS, check
from .raster import check_fields, field_grads, heavy_first_order

# kernel C's shared memory: the merge keys (8 bytes for each union lane),
# whose space the composite's batch stage (FWD_BATCH pairs × 37 bytes) then
# reuses, and the ordered list (4 bytes for each of k_cap lanes), within the
# 227 KB a block may opt into on Hopper
FWD_BATCH = 256        # csrc/tile_walk.cuh: kFwdBatch (held in tests)
STAGE_BYTES = FWD_BATCH * 37
MAX_SMEM_BYTES = 232_448 - 16


def merge_smem_bytes(config: RenderConfig) -> int:
    """Dynamic shared memory kernel C needs for this config."""
    union = 2 * c_max(config) * KCL
    return max(union * 8, STAGE_BYTES) + k_cap(config) * 4


def schedule_weight(abins: AnchorBins, gx: int, gy: int,
                    config: RenderConfig) -> Tuple[torch.Tensor, int]:
    """Kernel C's heavy-first weight (`csrc/anchor_fwd.cu::CoverWeight`)
    and its cap: the union positions a tile's merge reads, its two ranges'
    clipped cover lengths, capped at both covers' lanes."""
    return (cover_lengths(abins, gx, gy, config).sum(1),
            2 * c_max(config) * KCL)


def tile_order(abins: AnchorBins, gx: int, gy: int,
               config: RenderConfig) -> torch.Tensor:
    """The plain twin of kernel C's schedule."""
    return heavy_first_order(*schedule_weight(abins, gx, gy, config))


def _check_inputs(fields, abins, width, height, config):
    """Kernel C's checks: the fields and the anchor bins."""
    check_fields(fields, abins.sorted_gidx, config)
    dev = fields.device
    gx, gy = config.grid_size(width, height)
    m = abins.sorted_gidx.shape[0]
    for t, name, dtype in ((abins.sorted_meta, "sorted_meta", torch.uint8),
                           (abins.sorted_depth, "sorted_depth", torch.int32),
                           (abins.starts, "starts", torch.int32)):
        check(t, name, dtype, dev, 1)
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
    """Kernel C's checks and outputs → (run, (Composite, Merge, order)):
    each run() launches C once over every tile of the frame into the
    outputs, writing its tile schedule into `order` first."""
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
    order = torch.empty((gx * gy,), dtype=torch.int32, device=dev)
    ins = (fields, abins.sorted_gidx, abins.sorted_meta, abins.sorted_depth,
           abins.starts, order)

    def run():
        KERNELS["anchor_fwd"](
            dev, *(t.data_ptr() for t in ins),
            width, height, gx, gy, c_max(config), kc, smem,
            math.log(config.alpha_cutoff), config.alpha_max,
            math.log(config.transmittance_eps),
            *(t.data_ptr() for t in out + merge))

    return run, (out, merge, order)


def composite_anchor(fields: torch.Tensor, abins: AnchorBins, width: int,
                     height: int, config: RenderConfig
                     ) -> Tuple[Composite, Merge]:
    """The anchor forward → (Composite, Merge): kernel C for CUDA tensors,
    the plain version for CPU tensors. Not differentiable; see
    `composite_image_anchor`."""
    if not runs_kernels(fields.device, "compositor"):
        return composite_anchor_plain(fields, abins, width, height, config)
    run, (out, merge, _) = prepare_fwd(fields, abins, width, height, config)
    run()
    return out, merge


def composite_anchor_backward(fields: torch.Tensor, abins: AnchorBins,
                              width: int, height: int, config: RenderConfig,
                              composite: Composite, merge: Merge,
                              d_rgb: torch.Tensor,
                              d_alpha: torch.Tensor) -> torch.Tensor:
    """Pair gradient rows [4, M, 9] (row group, sorted entry position) from
    the forward's residual and ordered lists and the image cotangents:
    kernel D for CUDA tensors, the plain version (which redoes the merge)
    for CPU tensors."""
    if not runs_kernels(fields.device, "compositor"):
        return composite_anchor_backward_plain(
            fields, abins, width, height, config, composite, d_rgb, d_alpha)
    run, (dpairs, _) = prepare_bwd(fields, abins, width, height, config,
                                   composite, merge, d_rgb, d_alpha)
    run()
    return dpairs


def prepare_bwd(fields, abins, width, height, config, composite, merge,
                d_rgb, d_alpha):
    """Kernel D's checks and zeroed output → (run, (dpairs, order)): each
    run() launches D once over every tile of the frame into dpairs
    [4, M, 9], writing its tile schedule into `order` first."""
    check_fields(fields, abins.sorted_gidx, config)
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
        check(t, name, dtype, dev, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    pmax, kmax = torch.stack([merge.ordered.max().to(torch.int64),
                              merge.k_used.max().to(torch.int64)]).tolist()
    if pmax >= m or kmax > kc:
        raise ValueError("ordered lists index outside the entries or k_cap")
    dpairs = torch.zeros((4, m, GRAD_ROW), dtype=torch.float32, device=dev)
    order = torch.empty((gx * gy,), dtype=torch.int32, device=dev)
    ins = (fields, abins.sorted_gidx, merge.ordered, merge.k_used,
           merge.group, order, composite.final_log_t, composite.last_idx,
           d_rgb, d_alpha)

    def run():
        KERNELS["anchor_bwd"](
            dev, *(t.data_ptr() for t in ins),
            width, height, gx, gy, kc, m,
            math.log(config.alpha_cutoff), config.alpha_max,
            dpairs.data_ptr())

    return run, (dpairs, order)


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
    @tracing.spanned("composite_bwd")
    def backward(ctx, d_rgb, d_alpha, _d_log_t, _d_last):
        fields, final_log_t, last_idx, *merge = ctx.saved_tensors
        abins, width, height, config = ctx.frame
        residual = Composite(None, None, final_log_t, last_idx)
        d_fields = field_grads(
            fields, (d_rgb, d_alpha), ((height, width, 3), (height, width)),
            lambda *cot: composite_anchor_backward(
                fields, abins, width, height, config, residual,
                Merge(*merge), *cot),
            lambda rows: fold_anchor_grads(rows, abins, fields.shape[0],
                                           config))
        return d_fields, None, None, None, None


def composite_image_anchor(fields: torch.Tensor, abins: AnchorBins,
                           width: int, height: int,
                           config: RenderConfig) -> Composite:
    """Composite every tile of a width × height frame from the per-splat
    fields [N, 12] and the anchor bins → Composite (rgb, alpha,
    final_log_t, last_idx), differentiable in `fields`."""
    return Composite(*AnchorCompositeFn.apply(fields, abins, width, height,
                                              config))
