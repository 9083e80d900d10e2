"""Tile compositor and the full forward render of the port.

`composite_tiles` is the plain PyTorch compositor, a twin in exact f32 of
the JAX package's `ops/rasterize.py::_composite_chunk`: per 16×16 tile it
walks the depth-sorted segment `[tile_start, tile_start + min(count,
max_per_tile))` front to back with

  * power = log(opacity) − ½(A dx² + 2B dx dy + C dy²), evaluated as the
    rank-6 bilinear form in TILE-LOCAL pixel coordinates (integer 0..15,
    means minus the tile origin), summed in the order the CUDA kernel
    uses, so both give the same bits;
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

`rasterize_tiles` dispatches through the CUDA kernel's wrapper
(`ops/cuda/raster.py::composite_image`): a CUDA tensor launches kernel A,
a CPU tensor takes this plain twin.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from ..config import RenderConfig
from ..core.types import CameraParams, GaussianCloud
from .projection import ProjectedSplats, project_gaussians
from .sort import TileBins, bin_splats

FIELD_ROW = 12   # mx, my, conic a, b, c, r, g, b, opacity, 3 zero pads
CHUNK_ELEMS = 1 << 25   # bound on tiles·pairs·pixels per plain-twin chunk


class Composite(NamedTuple):
    """rgb [H, W, 3] premultiplied, alpha [H, W], final_log_t [H, W],
    last_idx [H, W] int32 (segment-local, −1 when no pair contributed)."""

    rgb: torch.Tensor
    alpha: torch.Tensor
    final_log_t: torch.Tensor
    last_idx: torch.Tensor


def pack_splat_fields(splats: ProjectedSplats) -> torch.Tensor:
    """Per-splat compositor fields as one contiguous [N, 12] f32 array
    (48-byte rows: three 16-byte loads per splat in the kernel)."""
    z = torch.zeros_like(splats.opacity)
    return torch.stack(
        [splats.mean2d[:, 0], splats.mean2d[:, 1],
         splats.conic[:, 0], splats.conic[:, 1], splats.conic[:, 2],
         splats.rgb[:, 0], splats.rgb[:, 1], splats.rgb[:, 2],
         splats.opacity, z, z, z],
        dim=-1,
    ).contiguous()


def composite_tiles(
    fields: torch.Tensor,
    bins: TileBins,
    tile_ids: torch.Tensor,
    gx: int,
    config: RenderConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite a list of tiles → (rgba [T, P, 4], final_log_t [T, P],
    last_idx [T, P] int32), P = tile_size², pixels row-major in the tile."""
    ts = config.tile_size
    p = ts * ts
    dev = fields.device
    f32 = torch.float32
    n_t = tile_ids.shape[0]

    starts = bins.tile_start[tile_ids].to(torch.int64)
    counts = torch.clamp(bins.tile_count[tile_ids],
                         max=config.max_per_tile).to(torch.int64)
    counts_host = counts.cpu()

    rgba = torch.zeros((n_t, p, 4), dtype=f32, device=dev)
    final_log_t = torch.zeros((n_t, p), dtype=f32, device=dev)
    last_idx = torch.full((n_t, p), -1, dtype=torch.int32, device=dev)
    k_max = int(counts_host.max()) if n_t else 0
    if k_max == 0:
        return rgba, final_log_t, last_idx

    u = torch.arange(ts, dtype=f32, device=dev)
    px = u.repeat(ts)                     # [P] tile-local x = pix % ts
    py = u.repeat_interleave(ts)          # [P] tile-local y = pix // ts
    pxx, pyy, pxy = px * px, py * py, px * py
    log_cut = math.log(config.alpha_cutoff)
    log_eps = math.log(config.transmittance_eps)

    chunk = max(1, CHUNK_ELEMS // (k_max * p))
    for c0 in range(0, n_t, chunk):
        sl = slice(c0, c0 + chunk)
        k_len = int(counts_host[sl].max())
        if k_len == 0:
            continue
        k = torch.arange(k_len, device=dev)
        live = k[None, :] < counts[sl, None]                   # [C, K]
        pos = torch.where(live, starts[sl, None] + k, 0)
        f = fields[bins.sorted_gidx[pos].to(torch.int64)]      # [C, K, 12]
        tid = tile_ids[sl].to(torch.int64)
        ox = ((tid % gx) * ts).to(f32)[:, None]
        oy = ((tid // gx) * ts).to(f32)[:, None]
        mx = f[..., 0] - ox
        my = f[..., 1] - oy
        ca, cb, cc = f[..., 2], f[..., 3], f[..., 4]
        rgb = f[..., 5:8]
        op = f[..., 8]

        v0 = torch.log(torch.clamp(op, min=1e-30)) - (
            0.5 * ca * mx * mx + cb * mx * my + 0.5 * cc * my * my)
        v1 = ca * mx + cb * my
        v2 = cc * my + cb * mx
        v3, v4, v5 = -0.5 * ca, -0.5 * cc, -cb
        power = (v0[..., None] + v1[..., None] * px + v2[..., None] * py
                 + v3[..., None] * pxx + v4[..., None] * pyy
                 + v5[..., None] * pxy)                          # [C, K, P]
        alpha = torch.where(
            live[..., None] & (power >= log_cut),
            torch.clamp(torch.exp(power), max=config.alpha_max), 0.0)

        log1m = torch.log1p(-alpha)
        log_t_incl = torch.cumsum(log1m, dim=1)
        log_t_excl = log_t_incl - log1m
        done = torch.cummax((log_t_incl < log_eps).to(torch.int32),
                            dim=1).values > 0
        w = torch.where(done, 0.0, alpha * torch.exp(log_t_excl))

        rgba[sl, :, :3] = torch.einsum("ckp,ckq->cpq", w, rgb)
        rgba[sl, :, 3] = w.sum(dim=1)
        final_log_t[sl] = torch.where(done, 0.0, log1m).sum(dim=1)
        contrib = ~done & (alpha > 0)
        last_idx[sl] = torch.where(contrib, k[None, :, None], -1).amax(
            dim=1).to(torch.int32)
    return rgba, final_log_t, last_idx


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
    """Composite all tiles: kernel A for CUDA tensors, the plain twin for
    CPU tensors."""
    from .cuda.raster import composite_image

    return composite_image(pack_splat_fields(splats), bins, width, height,
                           config)


def render_impl(
    cloud: GaussianCloud,
    camera: CameraParams,
    width: int,
    height: int,
    config: RenderConfig = RenderConfig(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full forward render on the cloud's device: project → bin →
    composite (+ background). Returns (image [H, W, 3], aux) with aux
    holding alpha and the binning counts."""
    camera = camera.to(cloud.device)
    splats = project_gaussians(cloud, camera, width, height, config)
    bins = bin_splats(splats, width, height, config)
    out = rasterize_tiles(splats, bins, width, height, config)

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
