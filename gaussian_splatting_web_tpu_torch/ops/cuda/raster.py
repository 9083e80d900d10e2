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

Both kernels run the tiles heavy first (each launch first writes the
schedule, `csrc/tile_order.cuh`) and skip the 8x4 pixel blocks a pair
cannot reach (`csrc/footprint.cuh`). `prepare_fwd` and `prepare_bwd` do a
launch's checks and allocations and return a callable that only launches,
so a kernel can be timed alone. `tile_order` and `footprint_blocks` are
the plain twins of the schedule and of the cull, and `cull_stats` holds
the cull against the twin's power; nothing on the render or training path
calls them.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ...config import RenderConfig
from .. import rasterize
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


ORDER_CLASSES = 2048    # csrc/tile_order.cuh: kOrderClasses (held in tests)


def tile_order(bins: TileBins, config: RenderConfig) -> torch.Tensor:
    """The plain twin of the heavy-first schedule kernels A and B write
    (`csrc/tile_order.cuh`): int32 tile ids in descending class of their
    capped pair count, ties in tile order (the kernel orders a class's
    tiles in any order)."""
    k_cap = config.max_per_tile
    count = torch.clamp(bins.tile_count.to(torch.int64), min=0, max=k_cap)
    if k_cap >= ORDER_CLASSES:
        count = count * (ORDER_CLASSES - 1) // k_cap
    return torch.argsort(count, descending=True, stable=True).to(torch.int32)


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
    fn, err_str = _kernel_fn("raster_fwd", 5, 5, 3, 4)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        global launches
        err = fn(*(t.data_ptr() for t in ins),
                 width, height, gx, gy, config.max_per_tile,
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
    fn, err_str = _kernel_fn("raster_bwd", 9, 5, 2, 1)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        global launches_bwd
        err = fn(*(t.data_ptr() for t in ins),
                 width, height, gx, gy, config.max_per_tile,
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
