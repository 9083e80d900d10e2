"""Tile compositor, its backward, and the full render of the port.

`composite_tiles` is the plain PyTorch compositor, a twin in exact f32 of
the JAX package's `ops/rasterize.py::_composite_chunk`: per 16×16 tile it
walks the depth-sorted segment `[tile_start, tile_start + min(count,
max_per_tile))` front to back with

  * power = log(opacity) − ½(A dx² + 2B dx dy + C dy²), evaluated as the
    rank-6 bilinear form in TILE-LOCAL pixel coordinates (integer 0..15,
    means minus the tile origin), summed in the order the CUDA kernel
    uses, so both give the same bits; with `pack_fields` and
    `pack_mean16` the tile-local mean goes through `quantize_mean16`
    first, as the JAX package's packed mean payload rounds it;
  * α = min(e^power, 0.99) where power ≥ log(1/255), else 0 (the cutoff is
    a compare on power, not on α);
  * the exclusive log-transmittance cumsum of log1p(−α); a pair
    contributes only while the INCLUSIVE log-T stays ≥ log(1e-4), and
    nothing after the first violator contributes (cummax);
  * premultiplied rgb and alpha.

Besides the image it returns INRIA's per-pixel residual for the backward
pass: the final log-transmittance (the log-T after the last contributing
pair) and the segment-local index of the last contributing pair (−1 when
none). These replace the TPU kernel's `fin` (final carry + chunk count).

`composite_backward_plain` is the plain twin of the backward kernel B
(the JAX package's `ops/pallas/raster_bwd.py::_bwd_kernel`): per pair
gradient rows in sorted pair order, and `fold_pair_grads` sums them back
onto the splats (`ops/pallas/raster.py::_fold_pair_grads`).

`composite_tiles_auto` composites a list of tiles, differentiably (the
sharded paths, `parallel/`). `bin_and_composite` passes the packed fields
through `highlight_selected` (`config.debug_selected`) after binning;
`composite_tiles_auto` does not. `rasterize_tiles` goes through the
differentiable compositor
(`ops/cuda/raster.py::composite_image`): a CUDA tensor launches kernels A
and B, a CPU tensor takes the plain twins. `bin_and_composite`, which
`render` and the training step call, takes that path or the anchor
binning's (`ops/anchor.py`, kernels C and D) by `config.binning`.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..config import RenderConfig
from ..core.types import CameraParams, GaussianCloud
from ..utils import tracing
from .projection import ProjectedSplats, project_gaussians
from .sort import (
    TileBins,
    bin_splats,
    mean16_on,
    quantize_bf16,
    quantize_mean16,
)

FIELD_ROW = 12   # mx, my, conic a, b, c, r, g, b, opacity, 3 zero pads
GRAD_ROW = 9     # d mx, my, conic a, b, c, r, g, b, opacity (raster_bwd.py:368)
CHUNK_ELEMS = 1 << 25   # bound on tiles·pairs·pixels per plain-twin chunk


class Composite(NamedTuple):
    """rgb [H, W, 3] premultiplied, alpha [H, W], final_log_t [H, W],
    last_idx [H, W] int32 (segment-local, −1 when no pair contributed)."""

    rgb: torch.Tensor
    alpha: torch.Tensor
    final_log_t: torch.Tensor
    last_idx: torch.Tensor


def pack_splat_fields(splats: ProjectedSplats,
                      config: RenderConfig | None = None) -> torch.Tensor:
    """Per-splat compositor fields as one contiguous [N, 12] f32 array
    (48-byte rows: three 16-byte loads per splat in the kernel). With
    `config.pack_fields` conic a/b/c, rgb and opacity go through
    `quantize_bf16` (JAX `ops/rasterize.py::pack_sorted_fields`); the mean
    stays f32 (`pack_mean16` rounds it per pair, tile-relative, where the
    compositor forms the tile-local mean)."""
    z = torch.zeros_like(splats.opacity)
    fields = torch.stack(
        [splats.mean2d[:, 0], splats.mean2d[:, 1],
         splats.conic[:, 0], splats.conic[:, 1], splats.conic[:, 2],
         splats.rgb[:, 0], splats.rgb[:, 1], splats.rgb[:, 2],
         splats.opacity, z, z, z],
        dim=-1,
    )
    if config is not None and config.pack_fields:
        fields = torch.cat([fields[:, :2], quantize_bf16(fields[:, 2:9]),
                            fields[:, 9:]], dim=-1)
    return fields.contiguous()


def highlight_selected(fields: torch.Tensor,
                       config: RenderConfig) -> torch.Tensor:
    """`config.debug_selected`'s highlight on the packed fields (JAX
    `ops/rasterize.py:235-248`, the reference's "selected" splat,
    simple_render.ts:171,181-190): gaussian k composites rgb (1, 0, 1) at
    opacity max(op, 0.9). Applied after binning, which keeps the footprint
    and cutoff of the real opacity, as the JAX package bins; the kernels
    see ordinary fields. Out of place; an id outside [0, N) selects
    nothing, as in the JAX package."""
    k = config.debug_selected
    if not 0 <= k < fields.shape[0]:
        return fields
    row = fields[k]
    lit = torch.cat([row[:5], row.new_tensor([1.0, 0.0, 1.0]),
                     torch.clamp(row[8:9], min=0.9), row[9:]])
    return torch.cat([fields[:k], lit[None], fields[k + 1:]])


class _Segments(NamedTuple):
    """One chunk of tiles' segments, padded to the chunk's longest: pair
    positions and liveness [C, K], fields [C, K, 12], tile-local means
    [C, K], power and α [C, K, P]."""

    pos: torch.Tensor
    live: torch.Tensor
    f: torch.Tensor
    mx: torch.Tensor
    my: torch.Tensor
    power: torch.Tensor
    alpha: torch.Tensor


def _pixel_coords(ts: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-local pixel coordinates [P] (pixels row-major in the tile)."""
    u = torch.arange(ts, dtype=torch.float32, device=device)
    return u.repeat(ts), u.repeat_interleave(ts)


def _chunks(bins: TileBins, tile_ids: torch.Tensor, config: RenderConfig):
    """(starts, counts, spans) of the tile list: each listed tile's segment
    start and capped count (the empty sentinel id gx·gy has none), and
    (slice, k_len) spans chunked so that one chunk's [C, K, P] temporaries
    hold at most CHUNK_ELEMS elements (empty chunks skipped)."""
    p = config.tile_size ** 2
    starts = F.pad(bins.tile_start, (0, 1))[tile_ids].to(torch.int64)
    counts = torch.clamp(F.pad(bins.tile_count, (0, 1))[tile_ids],
                         max=config.max_per_tile).to(torch.int64)
    counts_host = counts.cpu()
    n_t = tile_ids.shape[0]
    k_max = int(counts_host.max()) if n_t else 0
    spans = []
    if k_max:
        chunk = max(1, CHUNK_ELEMS // (k_max * p))
        for c0 in range(0, n_t, chunk):
            sl = slice(c0, c0 + chunk)
            k_len = int(counts_host[sl].max())
            if k_len:
                spans.append((sl, k_len))
    return starts, counts, spans


def _segments(fields, bins, tile_ids, starts, counts, sl, k_len, gx,
              config) -> _Segments:
    ts = config.tile_size
    dev = fields.device
    f32 = torch.float32
    px, py = _pixel_coords(ts, dev)
    k = torch.arange(k_len, device=dev)
    live = k[None, :] < counts[sl, None]                   # [C, K]
    pos = torch.where(live, starts[sl, None] + k, 0)
    f = fields[bins.sorted_gidx[pos].to(torch.int64)]      # [C, K, 12]
    tid = tile_ids[sl].to(torch.int64)
    ox = ((tid % gx) * ts).to(f32)[:, None]
    oy = ((tid // gx) * ts).to(f32)[:, None]
    mx = f[..., 0] - ox
    my = f[..., 1] - oy
    if mean16_on(config):
        mx, my = quantize_mean16(mx), quantize_mean16(my)
    ca, cb, cc = f[..., 2], f[..., 3], f[..., 4]
    op = f[..., 8]

    v0 = torch.log(torch.clamp(op, min=1e-30)) - (
        0.5 * ca * mx * mx + cb * mx * my + 0.5 * cc * my * my)
    v1 = ca * mx + cb * my
    v2 = cc * my + cb * mx
    v3, v4, v5 = -0.5 * ca, -0.5 * cc, -cb
    power = (v0[..., None] + v1[..., None] * px + v2[..., None] * py
             + v3[..., None] * (px * px) + v4[..., None] * (py * py)
             + v5[..., None] * (px * py))                     # [C, K, P]
    alpha = torch.where(
        live[..., None] & (power >= math.log(config.alpha_cutoff)),
        torch.clamp(torch.exp(power), max=config.alpha_max), 0.0)
    return _Segments(pos, live, f, mx, my, power, alpha)


def composite_tiles(
    fields: torch.Tensor,
    bins: TileBins,
    tile_ids: torch.Tensor,
    gx: int,
    config: RenderConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite a list of tiles → (rgba [T, P, 4], final_log_t [T, P],
    last_idx [T, P] int32), P = tile_size², pixels row-major in the tile.
    Pixels past the frame's edge are composited as if the frame went on;
    the empty sentinel id gx·gy gives rgba 0, log-T 0 and last index −1."""
    p = config.tile_size ** 2
    dev = fields.device
    n_t = tile_ids.shape[0]
    rgba = torch.zeros((n_t, p, 4), dtype=torch.float32, device=dev)
    final_log_t = torch.zeros((n_t, p), dtype=torch.float32, device=dev)
    last_idx = torch.full((n_t, p), -1, dtype=torch.int32, device=dev)
    log_eps = math.log(config.transmittance_eps)

    starts, counts, spans = _chunks(bins, tile_ids, config)
    for sl, k_len in spans:
        seg = _segments(fields, bins, tile_ids, starts, counts, sl, k_len,
                        gx, config)
        alpha = seg.alpha
        log1m = torch.log1p(-alpha)
        log_t_incl = torch.cumsum(log1m, dim=1)
        log_t_excl = log_t_incl - log1m
        done = torch.cummax((log_t_incl < log_eps).to(torch.int32),
                            dim=1).values > 0
        w = torch.where(done, 0.0, alpha * torch.exp(log_t_excl))

        rgba[sl, :, :3] = torch.einsum("ckp,ckq->cpq", w, seg.f[..., 5:8])
        rgba[sl, :, 3] = w.sum(dim=1)
        final_log_t[sl] = torch.where(done, 0.0, log1m).sum(dim=1)
        contrib = ~done & (alpha > 0)
        k = torch.arange(k_len, device=dev)
        last_idx[sl] = torch.where(contrib, k[None, :, None], -1).amax(
            dim=1).to(torch.int32)
    return rgba, final_log_t, last_idx


def tile_major(img: torch.Tensor, gx: int, gy: int, ts: int,
               fill: float = 0.0) -> torch.Tensor:
    """[H, W, C] → [gx·gy, ts², C], padding the ragged edge with `fill`
    (the transpose of `assemble_image`)."""
    h, w, c = img.shape
    img = F.pad(img, (0, 0, 0, gx * ts - w, 0, gy * ts - h), value=fill)
    return img.reshape(gy, ts, gx, ts, c).permute(0, 2, 1, 3, 4).reshape(
        gx * gy, ts * ts, c)


def composite_backward_plain(
    fields: torch.Tensor,
    bins: TileBins,
    width: int,
    height: int,
    config: RenderConfig,
    composite: Composite,
    d_rgb: torch.Tensor,
    d_alpha: torch.Tensor,
) -> torch.Tensor:
    """The plain twin of kernel B → per-pair gradient rows [M, 9] in
    sorted pair order (rows: mx, my, conic a, b, c, r, g, b, opacity),
    from the forward's residual and the image cotangents: every tile of the
    frame through `composite_tiles_backward_plain`."""
    ts = config.tile_size
    gx, gy = config.grid_size(width, height)
    tile_ids = torch.arange(gx * gy, device=fields.device)
    cot = tile_major(torch.cat([d_rgb, d_alpha[..., None]], -1), gx, gy, ts)
    last = tile_major(composite.last_idx[..., None], gx, gy, ts,
                      fill=-1)[..., 0]
    return composite_tiles_backward_plain(fields, bins, tile_ids, width,
                                          height, config, last, cot)


def composite_tiles_backward_plain(
    fields: torch.Tensor,
    bins: TileBins,
    tile_ids: torch.Tensor,
    width: int,
    height: int,
    config: RenderConfig,
    last_idx: torch.Tensor,
    d_rgba: torch.Tensor,
) -> torch.Tensor:
    """The plain twin of kernel B over a list of tiles → per-pair gradient
    rows [M, 9] in sorted pair order (rows: mx, my, conic a, b, c, r, g, b,
    opacity); rows of pairs of unlisted tiles are 0. `last_idx` [T, P] and
    the cotangent `d_rgba` [T, P, 4] are in the list's layout; pixels past
    the frame's edge take no part, and the empty sentinel id gx·gy does
    nothing.

    Per tile it recomputes α from the same rank-6 form as the forward,
    T_k from the exclusive log-T cumsum, and the suffix
    S_k = Σ_{j>k} r_j w_j with r = g_rgb·c + g_α (raster_bwd.py:8-12):
    dα = T r − S/(1−α) on the pairs that contributed (k ≤ the pixel's
    last_idx, α > 0), zero through the 0.99 clamp, dpow = dα·e^power.
    The geometry gradients come from pixel moments of dpow in tile-local
    coordinates (raster_bwd.py:337-358), d_op = Σ dpow / op. Pairs cut by
    the tile cap, and pairs no pixel reached, keep zero rows."""
    ts = config.tile_size
    dev = fields.device
    gx, _ = config.grid_size(width, height)
    m = bins.sorted_gidx.shape[0]
    out = torch.zeros((m, GRAD_ROW), dtype=torch.float32, device=dev)

    px, py = _pixel_coords(ts, dev)
    tid = tile_ids.to(torch.int64)
    inside = (((tid % gx) * ts)[:, None] + px.long() < width) & \
        (((tid // gx) * ts)[:, None] + py.long() < height)     # [T, P]
    cot = torch.where(inside[..., None], d_rgba, 0.0)
    last = torch.where(inside, last_idx, -1)
    u = torch.stack([torch.ones_like(px), px, py, px * px, py * py, px * py],
                    dim=-1)                                   # [P, 6]

    starts, counts, spans = _chunks(bins, tile_ids, config)
    for sl, k_len in spans:
        seg = _segments(fields, bins, tile_ids, starts, counts, sl, k_len,
                        gx, config)
        alpha = seg.alpha
        a_raw = torch.exp(seg.power)
        log1m = torch.log1p(-alpha)
        t = torch.exp(torch.cumsum(log1m, dim=1) - log1m)
        k = torch.arange(k_len, device=dev)
        contrib = (k[None, :, None] <= last[sl][:, None, :]) & (alpha > 0)
        w = torch.where(contrib, alpha * t, 0.0)
        g = cot[sl]                                           # [C, P, 4]
        r = torch.einsum("ckq,cpq->ckp", seg.f[..., 5:8], g[..., :3]) \
            + g[:, None, :, 3]
        rw = r * w
        s_incl = rw.flip(1).cumsum(1).flip(1)
        s = torch.cat([s_incl[:, 1:], torch.zeros_like(s_incl[:, :1])], 1)
        dalpha = torch.where(contrib, t * r - s / (1.0 - alpha), 0.0)
        dpow = torch.where(a_raw > config.alpha_max, 0.0, dalpha) * a_raw

        mom = torch.einsum("ckp,pm->ckm", dpow, u)            # [C, K, 6]
        m0, m1x, m1y, m2xx, m2yy, m2xy = mom.unbind(-1)
        mx, my = seg.mx, seg.my
        ca, cb, cc, op = (seg.f[..., 2], seg.f[..., 3], seg.f[..., 4],
                          seg.f[..., 8])
        c1x = m1x - mx * m0
        c1y = m1y - my * m0
        grads = torch.stack([
            ca * c1x + cb * c1y,
            cc * c1y + cb * c1x,
            -0.5 * (m2xx - 2.0 * mx * m1x + mx * mx * m0),
            -(m2xy - mx * m1y - my * m1x + mx * my * m0),
            -0.5 * (m2yy - 2.0 * my * m1y + my * my * m0),
        ], dim=-1)
        color = torch.einsum("ckp,cpq->ckq", w, g[..., :3])   # [C, K, 3]
        d_op = m0 / torch.clamp(op, min=1e-30)
        rows = torch.cat([grads, color, d_op[..., None]], dim=-1)
        out[seg.pos[seg.live]] = rows[seg.live]
    return out


@tracing.spanned("fold")
def fold_pair_grads(dpairs: torch.Tensor, bins: TileBins, n: int,
                    config: RenderConfig | None = None) -> torch.Tensor:
    """Sum the sorted pair gradients [M, 9] back onto the splats → [N, 9]
    (JAX `ops/pallas/raster.py::_fold_pair_grads`).

    Pair position i came from slot `sorted_slot[i]`, and the map is a
    permutation, so the rows are copied (never added) into a zero [S, 9]
    buffer over all S slots. Tier A's slot-major [d_a, N] block is summed
    over its slot axis; each compacted tier's [w_j, cap_j] block is summed
    over w_j and its real rows copied to their gaussians, which are unique
    (a gaussian sits in one tier): deterministic, no atomics. Slots with no
    row (dead, or cut by the gather cap) stay zero. With
    `config.pack_grads` each pair row is first rounded to bf16 (round to
    nearest even), as JAX's packed sort payloads round it. The buffer is
    S·36 bytes: 576 MB at 1M splats single-tier with max_dup 16, 124 MB
    with JAX's default tiers (2, 4, 16)."""
    if config is not None and config.pack_grads:
        dpairs = quantize_bf16(dpairs)
    slots = bins.sorted_slot.shape[0]
    if n == 0:
        return dpairs.new_zeros((0, GRAD_ROW))
    buf = dpairs.new_zeros((slots, GRAD_ROW))
    buf.index_copy_(0, bins.sorted_slot[:dpairs.shape[0]].long(), dpairs)
    d_a = bins.tier_a_width or slots // n
    seg = buf[:n * d_a].reshape(d_a, n, GRAD_ROW).sum(0)
    if not bins.comp_widths:
        return seg
    comp = buf.new_zeros((n + 1, GRAD_ROW))   # row n takes the padding rows
    off = n * d_a
    for w_j, idx_j, cnt_j in zip(bins.comp_widths, bins.comp_idx,
                                 bins.comp_count):
        cap_j = idx_j.shape[0]
        rows_j = buf[off:off + w_j * cap_j].reshape(w_j, cap_j, GRAD_ROW)
        real = torch.arange(cap_j, device=idx_j.device) < cnt_j
        comp.index_copy_(0, torch.where(real, idx_j, n), rows_j.sum(0))
        off += w_j * cap_j
    return seg + comp[:n]


def assemble_image(tiles: torch.Tensor, width: int, height: int,
                   gx: int, gy: int) -> torch.Tensor:
    """[gx·gy, P, C] (row-major tile order) → [H, W, C]."""
    c = tiles.shape[-1]
    ts = math.isqrt(tiles.shape[1])
    out = tiles.reshape(gy, gx, ts, ts, c).permute(0, 2, 1, 3, 4)
    return out.reshape(gy * ts, gx * ts, c)[:height, :width]


def composite_image_plain(fields: torch.Tensor, bins: TileBins, width: int,
                          height: int, config: RenderConfig) -> Composite:
    """The plain twin of kernel A over every tile of the frame."""
    gx, gy = config.grid_size(width, height)
    tile_ids = torch.arange(gx * gy, device=fields.device)
    rgba, log_t, last = composite_tiles(fields, bins, tile_ids, gx, config)

    def image(t):
        return assemble_image(t, width, height, gx, gy)

    img = image(rgba)
    return Composite(rgb=img[..., :3], alpha=img[..., 3],
                     final_log_t=image(log_t[..., None])[..., 0],
                     last_idx=image(last[..., None])[..., 0])


def rasterize_tiles(
    splats: ProjectedSplats,
    bins: TileBins,
    width: int,
    height: int,
    config: RenderConfig,
) -> Composite:
    """Composite all tiles, differentiably: kernels A and B for CUDA
    tensors, the plain twins for CPU tensors."""
    from .cuda.raster import composite_image

    with tracing.span("composite"):
        fields = highlight_selected(pack_splat_fields(splats, config),
                                    config)
        return composite_image(fields, bins, width, height, config)


def composite_tiles_auto(splats: ProjectedSplats, tile_ids: torch.Tensor,
                         width: int, height: int, config: RenderConfig,
                         gx: int) -> torch.Tensor:
    """Composite a tile-id subset → [L, ts, ts, 4] rgba, differentiable in
    the splats: the JAX package's `composite_tiles_auto`, which the
    tile-sharded paths call with the tiles each rank owns. Bins with
    `bin_splats` (the dup binning, whatever `config.binning` says, as the
    JAX package does), then `ops/cuda/raster.py::composite_tiles_subset`:
    kernel A's and B's tile-list entries for CUDA tensors, the plain twins
    for CPU tensors. `tile_ids` is int32 [L], ids in [0, gx·gy], padded with
    the empty sentinel gx·gy (never with a repeated real id). No
    `debug_selected` highlight, as on the JAX package's TPU route
    (`composite_tiles_subset_pallas`): the banded paths hand it compacted
    candidates, whose row k is not gaussian k."""
    from .cuda.raster import composite_tiles_subset

    if config.grid_size(width, height)[0] != gx:
        raise ValueError(f"gx={gx} is not the frame's {width}x{height} grid")
    bins = bin_splats(splats, width, height, config)
    ts = config.tile_size
    tiles = composite_tiles_subset(pack_splat_fields(splats, config), bins,
                                   tile_ids.to(torch.int32), width, height,
                                   config)
    return tiles.reshape(-1, ts, ts, 4)


def uses_anchor(width: int, height: int, config: RenderConfig) -> bool:
    """Whether `bin_and_composite` takes the anchor binning: the packed
    anchor key holds the tile id in 16 bits, so a packed frame of 65,536
    tiles or more falls back to the dup binning, as the JAX package's
    `select_fused_rasterizer` (`ops/rasterize.py:435-448`) does."""
    return config.binning == "anchor" and (
        config.num_tiles(width, height) < (1 << 16) or not config.pack_fields)


def bin_and_composite(splats: ProjectedSplats, width: int, height: int,
                      config: RenderConfig):
    """Bin and composite by `config.binning`, differentiably → (Composite,
    bins): 'dup' takes `bin_splats` and kernels A and B, 'anchor' takes
    `ops/anchor.py::bin_splats_anchor` and kernels C and D (the plain
    versions on the CPU), but for `uses_anchor`'s fallback. Both bins
    carry `num_pairs` and `overflow`."""
    if uses_anchor(width, height, config):
        from .anchor import bin_splats_anchor
        from .cuda.anchor import composite_image_anchor

        bins = bin_splats_anchor(splats, width, height, config)
        with tracing.span("composite"):
            fields = highlight_selected(pack_splat_fields(splats, config),
                                        config)
            return composite_image_anchor(fields, bins, width, height,
                                          config), bins
    bins = bin_splats(splats, width, height, config)
    return rasterize_tiles(splats, bins, width, height, config), bins


@tracing.spanned("render")
def render_impl(
    cloud: GaussianCloud,
    camera: CameraParams,
    width: int,
    height: int,
    config: RenderConfig = RenderConfig(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full render on the cloud's device: project → bin → composite
    (+ background), differentiable in the cloud's parameters. Returns
    (image [H, W, 3], aux) with aux holding alpha and the binning counts.
    A `config.dtype` of bfloat16 stores the cloud by
    `GaussianCloud.with_storage_dtype` first (a no-op on a cloud already
    stored so), as JAX `ops/rasterize.py:466-472` does."""
    cloud = cloud.with_storage_dtype(config.dtype)
    camera = camera.to(cloud.device)
    splats = project_gaussians(cloud, camera, width, height, config)
    out, bins = bin_and_composite(splats, width, height, config)

    with tracing.span("composite"):
        bg = torch.tensor(config.background, dtype=out.rgb.dtype,
                          device=out.rgb.device)
        img = out.rgb + (1.0 - out.alpha[..., None]) * bg
    aux = {
        "alpha": out.alpha,
        "num_pairs": bins.num_pairs,
        "overflow": bins.overflow,
        "num_visible": splats.valid.sum(),
    }
    return img, aux


render = render_impl
