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
`fold_pair_grads`. `composite_tiles_subset` (`CompositeTilesFn`) does the
same over a list of tile ids with A's and B's tile-list entries (E, which
replace `composite_tiles_pallas(tile_ids=)` and
`backward_pair_grads(tile_ids=)`), writing tiles in list order, and their
twins `ops/rasterize.py::composite_tiles` and
`composite_tiles_backward_plain`. `launches`, `launches_bwd`,
`launches_tiles` and `launches_tiles_bwd` count kernel launches and are
changed nowhere else.

Both kernels run the tiles heavy first (each launch first writes the
schedule, `csrc/tile_order.cuh`) and skip the 8x4 pixel blocks a pair
cannot reach (`csrc/footprint.cuh`). Every entry takes the `mean16` flag
(`config.pack_fields and config.pack_mean16`): each pair's tile-local mean
is then rounded to 1/32 px as the twin's `_segments` rounds it, and the
backward folds with `config.pack_grads`. `prepare_fwd` and `prepare_bwd` (and
`prepare_fwd_tiles`, `prepare_bwd_tiles`) do a launch's checks and
allocations and return a callable that only launches, so a kernel can be
timed alone. `heavy_first_order` (with `tile_order` for A and B,
`tile_list_order` for their list entries) and `footprint_blocks` are the
plain twins of the schedule and of the cull, and `cull_stats` holds the
cull against the twin's power; nothing on the render or training path
calls them.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...config import RenderConfig
from ...utils import tracing
from .. import rasterize
from ..rasterize import (
    FIELD_ROW,
    GRAD_ROW,
    Composite,
    composite_backward_plain,
    composite_image_plain,
    composite_tiles,
    composite_tiles_backward_plain,
    fold_pair_grads,
)
from ..sort import TileBins, mean16_on
from . import build

launches = 0             # kernel A
launches_bwd = 0         # kernel B
launches_tiles = 0       # kernel A's tile-list entry
launches_tiles_bwd = 0   # kernel B's tile-list entry


class TileOutputs(NamedTuple):
    """The tile-list entries' outputs in list-position layout: rgba
    [L, 256, 4] premultiplied, final_log_t [L, 256], last_idx [L, 256]
    int32 (pixels row-major in the tile)."""

    rgba: torch.Tensor
    final_log_t: torch.Tensor
    last_idx: torch.Tensor


def _kernel_fn(name: str, n_ptr_in: int, n_int: int, n_float: int,
               n_ptr_out: int, entry: str | None = None):
    """The extern "C" launcher `entry` (default `name`) of csrc/<name>.cu,
    its argument types set, and the source's error-string function."""
    lib = build.load(name)
    fn = getattr(lib, entry or name)
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


def _check_inputs(fields, bins, width, height, config, tile_ids=None):
    """Checks shared by both kernels: tile size, field layout, bins and,
    for the tile-list entries, `tile_ids` (ids in [0, gx·gy], gx·gy the
    empty sentinel, no real id twice), in one host sync."""
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
    if tile_ids is not None:
        _check(tile_ids, "tile_ids", torch.int32, dev, 1)
    checks = {}
    if m:
        checks["end"] = (bins.tile_start.to(torch.int64) + torch.clamp(
            bins.tile_count, max=config.max_per_tile)).max()
        checks["gmin"] = bins.sorted_gidx.min().to(torch.int64)
        checks["gmax"] = bins.sorted_gidx.max().to(torch.int64)
    t = gx * gy
    if tile_ids is not None and tile_ids.numel():
        ids = tile_ids.to(torch.int64)
        hits = torch.zeros(t + 1, dtype=torch.int64, device=dev).index_add_(
            0, ids.clamp(0, t), torch.ones_like(ids))
        checks["lo"], checks["hi"] = ids.min(), ids.max()
        checks["most"] = hits[:t].max()
    if checks:
        got = dict(zip(checks, torch.stack(list(checks.values())).tolist()))
        if m and (got["end"] > m or got["gmin"] < 0
                  or got["gmax"] >= fields.shape[0]):
            raise ValueError("bins index outside the pair or splat arrays")
        if "lo" in got and (got["lo"] < 0 or got["hi"] > t):
            raise ValueError(f"tile_ids hold ids in {got['lo']}..{got['hi']}"
                             f", outside [0, {t}] ({t} is the empty "
                             "sentinel)")
        if "most" in got and got["most"] > 1:
            raise ValueError("tile_ids list a tile more than once; pad with "
                             f"the empty sentinel {t}")
    return gx, gy


ORDER_CLASSES = 2048    # csrc/tile_order.cuh: kOrderClasses (held in tests)


def order_class(weight: torch.Tensor, cap: int) -> torch.Tensor:
    """`csrc/tile_order.cuh::order_class`: the weight capped at `cap`, in
    ORDER_CLASSES equal bins once cap reaches ORDER_CLASSES."""
    w = torch.clamp(weight.to(torch.int64), min=0, max=cap)
    return w * (ORDER_CLASSES - 1) // cap if cap >= ORDER_CLASSES else w


def heavy_first_order(weight: torch.Tensor, cap: int) -> torch.Tensor:
    """The plain twin of the heavy-first schedule the kernels write
    (`csrc/tile_order.cuh`): int32 tile ids in descending class of their
    weight, ties in tile order (the kernel orders a class's tiles in any
    order). Kernel D's weight is its ordered lists' length `k_used`, capped
    at k_cap."""
    return torch.argsort(order_class(weight, cap), descending=True,
                         stable=True).to(torch.int32)


def tile_order(bins: TileBins, config: RenderConfig) -> torch.Tensor:
    """Kernels A's and B's schedule: the capped pair count."""
    return heavy_first_order(bins.tile_count, config.max_per_tile)


def tile_list_order(bins: TileBins, tile_ids: torch.Tensor,
                    config: RenderConfig) -> torch.Tensor:
    """The tile-list entries' schedule: list positions by the capped pair
    count of their tile, 0 for the empty sentinel."""
    counts = F.pad(bins.tile_count, (0, 1))[tile_ids.long()]
    return heavy_first_order(counts, config.max_per_tile)


def _device_of(fields: torch.Tensor) -> str:
    if fields.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no compositor for device {fields.device}")
    return fields.device.type


def _forward(fields, bins, width, height, config) -> Composite:
    if _device_of(fields) == "cpu":
        return composite_image_plain(fields, bins, width, height, config)
    return _launch(fields, bins, width, height, config)


def prepare_fwd(fields, bins, width, height, config):
    """Kernel A's checks and outputs → (run, (Composite, order)): each
    run() launches A once over every tile of the frame into the outputs,
    writing its tile schedule into `order` first."""
    gx, gy = _check_inputs(fields, bins, width, height, config)
    dev = fields.device
    out = Composite(
        rgb=torch.empty((height, width, 3), dtype=torch.float32, device=dev),
        alpha=torch.empty((height, width), dtype=torch.float32, device=dev),
        final_log_t=torch.empty((height, width), dtype=torch.float32,
                                device=dev),
        last_idx=torch.empty((height, width), dtype=torch.int32, device=dev))
    order = torch.empty((gx * gy,), dtype=torch.int32, device=dev)
    ins = (fields, bins.sorted_gidx, bins.tile_start, bins.tile_count, order)
    fn, err_str = _kernel_fn("raster_fwd", 5, 6, 3, 4)
    stream = torch.cuda.current_stream(dev).cuda_stream
    mean16 = int(mean16_on(config))

    def run():
        global launches
        err = fn(*(t.data_ptr() for t in ins),
                 width, height, gx, gy, config.max_per_tile, mean16,
                 math.log(config.alpha_cutoff), config.alpha_max,
                 math.log(config.transmittance_eps),
                 *(t.data_ptr() for t in out), dev.index, stream)
        if err != 0:
            raise RuntimeError(f"raster_fwd launch failed: cuda error {err} "
                               f"({err_str(err).decode()})")
        launches += 1

    return run, (out, order)


def _launch(fields, bins, width, height, config) -> Composite:
    """Kernel A over every tile of the frame."""
    run, (out, _) = prepare_fwd(fields, bins, width, height, config)
    run()
    return out


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


def prepare_bwd(fields, bins, width, height, config, composite, d_rgb,
                d_alpha):
    """Kernel B's checks and zeroed output → (run, (dpairs, order)): each
    run() launches B once over every tile of the frame into dpairs [M, 9],
    writing its tile schedule into `order` first."""
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
    order = torch.empty((gx * gy,), dtype=torch.int32, device=dev)
    ins = (fields, bins.sorted_gidx, bins.tile_start, bins.tile_count, order,
           composite.final_log_t, composite.last_idx, d_rgb, d_alpha)
    fn, err_str = _kernel_fn("raster_bwd", 9, 6, 2, 1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    mean16 = int(mean16_on(config))

    def run():
        global launches_bwd
        err = fn(*(t.data_ptr() for t in ins),
                 width, height, gx, gy, config.max_per_tile, mean16,
                 math.log(config.alpha_cutoff), config.alpha_max,
                 dpairs.data_ptr(), dev.index, stream)
        if err != 0:
            raise RuntimeError(f"raster_bwd launch failed: cuda error {err} "
                               f"({err_str(err).decode()})")
        launches_bwd += 1

    return run, (dpairs, order)


def _launch_bwd(fields, bins, width, height, config, composite, d_rgb,
                d_alpha) -> torch.Tensor:
    """Kernel B over every tile of the frame."""
    run, (dpairs, _) = prepare_bwd(fields, bins, width, height, config,
                                   composite, d_rgb, d_alpha)
    run()
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
    @tracing.spanned("composite_bwd")
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
        seg = fold_pair_grads(dpairs, bins, fields.shape[0], config)
        return F.pad(seg, (0, FIELD_ROW - GRAD_ROW)), None, None, None, None


def composite_image(fields: torch.Tensor, bins: TileBins, width: int,
                    height: int, config: RenderConfig) -> Composite:
    """Composite every tile of a width × height frame from the per-splat
    fields [N, 12] and the bins → Composite (rgb, alpha, final_log_t,
    last_idx), differentiable in `fields`."""
    _device_of(fields)
    return Composite(*CompositeFn.apply(fields, bins, width, height, config))


# --- the tile-list entries (composite_tiles_subset_pallas) -----------------


def prepare_fwd_tiles(fields, bins, tile_ids, width, height, config):
    """Kernel A's tile-list entry: checks and outputs → (run, (TileOutputs,
    order)): each run() launches A once over the L entries of `tile_ids`
    into the tile-major outputs, writing its schedule of list positions into
    `order` first."""
    gx, gy = _check_inputs(fields, bins, width, height, config, tile_ids)
    dev = fields.device
    n_ids = tile_ids.shape[0]
    p = config.tile_size ** 2
    out = TileOutputs(
        rgba=torch.empty((n_ids, p, 4), dtype=torch.float32, device=dev),
        final_log_t=torch.empty((n_ids, p), dtype=torch.float32, device=dev),
        last_idx=torch.empty((n_ids, p), dtype=torch.int32, device=dev))
    order = torch.empty((n_ids,), dtype=torch.int32, device=dev)
    ins = (fields, bins.sorted_gidx, bins.tile_start, bins.tile_count,
           tile_ids, order)
    fn, err_str = _kernel_fn("raster_fwd", 6, 7, 3, 3,
                              entry="raster_fwd_tiles")
    stream = torch.cuda.current_stream(dev).cuda_stream
    mean16 = int(mean16_on(config))

    def run():
        global launches_tiles
        err = fn(*(t.data_ptr() for t in ins),
                 n_ids, width, height, gx, gy, config.max_per_tile, mean16,
                 math.log(config.alpha_cutoff), config.alpha_max,
                 math.log(config.transmittance_eps),
                 *(t.data_ptr() for t in out), dev.index, stream)
        if err != 0:
            raise RuntimeError(f"raster_fwd_tiles launch failed: cuda error "
                               f"{err} ({err_str(err).decode()})")
        launches_tiles += 1

    return run, (out, order)


def prepare_bwd_tiles(fields, bins, tile_ids, width, height, config,
                      final_log_t, last_idx, d_rgba):
    """Kernel B's tile-list entry: checks and zeroed output → (run, (dpairs,
    order)): each run() launches B once over the L entries of `tile_ids`,
    reading the residual final_log_t, last_idx [L, 256] and the cotangent
    d_rgba [L, 256, 4] in list-position layout, into dpairs [M, 9]."""
    gx, gy = _check_inputs(fields, bins, width, height, config, tile_ids)
    dev = fields.device
    n_ids = tile_ids.shape[0]
    p = config.tile_size ** 2
    _check(final_log_t, "final_log_t", torch.float32, dev, 2)
    _check(last_idx, "last_idx", torch.int32, dev, 2)
    _check(d_rgba, "d_rgba", torch.float32, dev, 3)
    for t, name, shape in ((final_log_t, "final_log_t", (n_ids, p)),
                           (last_idx, "last_idx", (n_ids, p)),
                           (d_rgba, "d_rgba", (n_ids, p, 4))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    dpairs = torch.zeros((bins.sorted_gidx.shape[0], GRAD_ROW),
                         dtype=torch.float32, device=dev)
    order = torch.empty((n_ids,), dtype=torch.int32, device=dev)
    ins = (fields, bins.sorted_gidx, bins.tile_start, bins.tile_count,
           tile_ids, order, final_log_t, last_idx, d_rgba)
    fn, err_str = _kernel_fn("raster_bwd", 9, 7, 2, 1,
                              entry="raster_bwd_tiles")
    stream = torch.cuda.current_stream(dev).cuda_stream
    mean16 = int(mean16_on(config))

    def run():
        global launches_tiles_bwd
        err = fn(*(t.data_ptr() for t in ins),
                 n_ids, width, height, gx, gy, config.max_per_tile, mean16,
                 math.log(config.alpha_cutoff), config.alpha_max,
                 dpairs.data_ptr(), dev.index, stream)
        if err != 0:
            raise RuntimeError(f"raster_bwd_tiles launch failed: cuda error "
                               f"{err} ({err_str(err).decode()})")
        launches_tiles_bwd += 1

    return run, (dpairs, order)


def composite_tiles_list(fields, bins, tile_ids, width, height,
                         config) -> TileOutputs:
    """The tiles at the L entries of `tile_ids` → TileOutputs (rgba [L,
    256, 4], final_log_t, last_idx [L, 256]), not differentiable: kernel
    A's tile-list entry for CUDA tensors, the plain twin
    (`ops/rasterize.py::composite_tiles`) for CPU tensors. The kernel
    writes pixels outside the frame as taking no part (rgba 0, log-T 0,
    last index -1); the twin composites them as if the frame went on. Both
    give the empty sentinel id gx·gy a slot of rgba 0, log-T 0 and -1."""
    if _device_of(fields) == "cpu":
        gx, _ = config.grid_size(width, height)
        return TileOutputs(*composite_tiles(fields, bins, tile_ids, gx,
                                            config))
    run, (out, _) = prepare_fwd_tiles(fields, bins, tile_ids, width, height,
                                      config)
    run()
    return out


def composite_tiles_backward(fields, bins, tile_ids, width, height, config,
                             final_log_t, last_idx,
                             d_rgba) -> torch.Tensor:
    """Per-pair gradient rows [M, 9] of the listed tiles' pairs (rows of
    unlisted tiles' pairs are 0) from the residual and the cotangent d_rgba
    [L, 256, 4] in list-position layout: kernel B's tile-list entry for
    CUDA tensors, the plain twin for CPU tensors. Pixels outside the frame
    take no part."""
    if _device_of(fields) == "cpu":
        return composite_tiles_backward_plain(fields, bins, tile_ids, width,
                                              height, config, last_idx,
                                              d_rgba)
    run, (dpairs, _) = prepare_bwd_tiles(fields, bins, tile_ids, width,
                                         height, config, final_log_t,
                                         last_idx, d_rgba)
    run()
    return dpairs


class CompositeTilesFn(torch.autograd.Function):
    """fields [N, 12] → (rgba [L, 256, 4], final_log_t, last_idx [L, 256])
    over the L entries of `tile_ids`; the residual outputs and `tile_ids`
    carry no gradient. The backward returns the folded pair gradients
    widened to [N, 12] with zero pads."""

    @staticmethod
    def forward(ctx, fields, bins, tile_ids, width, height, config):
        out = composite_tiles_list(fields, bins, tile_ids, width, height,
                                   config)
        ctx.mark_non_differentiable(out.final_log_t, out.last_idx)
        ctx.save_for_backward(fields, tile_ids, out.final_log_t,
                              out.last_idx)
        ctx.frame = (bins, width, height, config)
        return tuple(out)

    @staticmethod
    @tracing.spanned("composite_bwd")
    def backward(ctx, d_rgba, _d_log_t, _d_last):
        fields, tile_ids, final_log_t, last_idx = ctx.saved_tensors
        bins, width, height, config = ctx.frame
        dpairs = composite_tiles_backward(
            fields, bins, tile_ids, width, height, config, final_log_t,
            last_idx, d_rgba.contiguous())
        seg = fold_pair_grads(dpairs, bins, fields.shape[0], config)
        return (F.pad(seg, (0, FIELD_ROW - GRAD_ROW)), None, None, None,
                None, None)


def composite_tiles_subset(fields: torch.Tensor, bins: TileBins,
                           tile_ids: torch.Tensor, width: int, height: int,
                           config: RenderConfig) -> torch.Tensor:
    """Composite the tiles at the entries of `tile_ids` (int32 [L], ids in
    [0, gx·gy], gx·gy the empty sentinel, no real id twice) → rgba
    [L, 256, 4] premultiplied, differentiable in `fields`: the port of the
    JAX package's `composite_tiles_subset_pallas`."""
    _device_of(fields)
    return CompositeTilesFn.apply(fields, bins, tile_ids, width, height,
                                  config)[0]


# --- the footprint cull's plain mirror (tests and chip_smoke only) --------

# copies of csrc/footprint.cuh's kBlockW, kBlockH, kCullRel, kCullWiden and
# kCullPad (tests/test_torch_cull.py holds them against the header)
BLOCK = (8, 4)          # the kernels' warp block, pixels in x and y
CULL_REL, CULL_WIDEN, CULL_PAD = 1e-5, 1.001, 1e-3


def footprint_blocks(mx, my, ca, cb, cc, log_op,
                     log_cut: float) -> torch.Tensor:
    """The plain mirror of `csrc/footprint.cuh::footprint_blocks` on
    float32 tensors of tile-local means, conics and log-opacities → int64
    masks, bit w set when the pair's power may reach `log_cut` in warp w's
    8x4 pixel block of the 16x16 tile (blocks row-major). Each operation
    rounds as the kernel's does; the margin is derived in the header."""
    bw, bh = BLOCK
    nbx = 16 // bw

    def c(v):
        return torch.tensor(v, dtype=torch.float32, device=mx.device)

    amx, amy = mx.abs(), my.abs()
    aa, ab, ac = ca.abs(), cb.abs(), cc.abs()
    s = log_op.abs()
    s = s + c(0.5) * aa * amx * amx
    s = s + ab * amx * amy
    s = s + c(0.5) * ac * amy * amy
    lin = (aa * amx + ab * amy) + (ac * amy + ab * amx)
    s = s + c(15.0) * lin
    s = s + c(225.0) * ((c(0.5) * aa + c(0.5) * ac) + ab)
    det = ca * cc - cb * cb
    det_lo = det - c(CULL_REL) * (aa * ac + ab * ab)
    keep_all = ~((s <= 3.0e38) & (ca > 0) & (det_lo > 0))
    margin = c(CULL_REL) * (s + c(abs(log_cut)))
    r2 = c(2.0) * ((log_op - c(log_cut)) + margin)
    hx = torch.sqrt(r2 * cc / det_lo) * c(CULL_WIDEN) + c(CULL_PAD)
    hy = torch.sqrt(r2 * ca / det_lo) * c(CULL_WIDEN) + c(CULL_PAD)
    x_lo, x_hi, y_lo, y_hi = mx - hx, mx + hx, my - hy, my + hy
    mask = torch.zeros(mx.shape, dtype=torch.int64, device=mx.device)
    for w in range(nbx * (16 // bh)):
        x0, y0 = float((w % nbx) * bw), float((w // nbx) * bh)
        meets = ((x0 + bw - 1 >= x_lo) & (x0 <= x_hi)
                 & (y0 + bh - 1 >= y_lo) & (y0 <= y_hi))
        mask = mask | (meets.to(torch.int64) << w)
    full = (1 << (nbx * (16 // bh))) - 1
    return torch.where(keep_all, full, torch.where(r2 < 0, 0, mask))


def pixel_blocks(device="cpu") -> torch.Tensor:
    """Block index [256] of each tile-local pixel (pixels row-major)."""
    bw, bh = BLOCK
    px, py = rasterize._pixel_coords(16, device)
    return (py.long() // bh) * (16 // bw) + px.long() // bw


def cull_stats(fields, bins, width, height, config: RenderConfig) -> dict:
    """Holds `footprint_blocks` against the plain twin's power over every
    live (pair, pixel) step of the frame's pixels → counts: `steps` and
    `culled` (all live steps), `walked` and `walked_culled` (steps up to
    each pixel's early exit, the steps kernel A's first port evaluated),
    and `missed`, the culled steps whose power passes the cutoff (the cull
    is right only when it is 0)."""
    if config.tile_size != 16:
        raise ValueError(f"the cull is built for tile_size=16, got "
                         f"{config.tile_size}")
    gx, gy = config.grid_size(width, height)
    dev = fields.device
    tile_ids = torch.arange(gx * gy, device=dev)
    inside = rasterize.tile_major(torch.ones((height, width, 1), device=dev),
                                  gx, gy, 16)[..., 0] > 0        # [T, P]
    blk = pixel_blocks(dev)
    log_cut = math.log(config.alpha_cutoff)
    log_eps = math.log(config.transmittance_eps)
    totals = torch.zeros(5, dtype=torch.int64, device=dev)
    starts, counts, spans = rasterize._chunks(bins, tile_ids, config)
    with torch.no_grad():
        for sl, k_len in spans:
            seg = rasterize._segments(fields, bins, tile_ids, starts, counts,
                                      sl, k_len, gx, config)
            log_op = torch.log(torch.clamp(seg.f[..., 8], min=1e-30))
            mask = footprint_blocks(seg.mx, seg.my, seg.f[..., 2],
                                    seg.f[..., 3], seg.f[..., 4], log_op,
                                    log_cut)
            kept = ((mask[..., None] >> blk) & 1) > 0           # [C, K, P]
            live = seg.live[..., None] & inside[sl][:, None, :]
            culled = live & ~kept
            exits = torch.cumsum(torch.log1p(-seg.alpha), 1) < log_eps
            walked = live & ((torch.cumsum(exits.to(torch.int32), 1)
                              - exits.to(torch.int32)) == 0)
            totals += torch.stack([
                live.sum(), culled.sum(), walked.sum(),
                (walked & ~kept).sum(),
                (culled & (seg.power >= log_cut)).sum()])
    names = ("steps", "culled", "walked", "walked_culled", "missed")
    return dict(zip(names, (int(v) for v in totals.tolist())))
