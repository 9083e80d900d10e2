"""Tile binning: depth-ordered per-tile splat segments, the port of the
JAX package's `ops/sort.py::bin_splats` in its exact single-tier mode
(`depth_bits=0, tier_split=0`).

Each gaussian owns `max_dup` candidate slots in a slot-major [d, N] grid
(slot id k·N + g); slot k holds the k-th tile of its footprint rect in
row-major order. The JAX package sorts the whole grid, dead slots carrying
the sentinel tile `num_tiles` so they sort last. Here the live slots are
compacted first (`nonzero`, ascending slot ids), which changes no live
position because the dead slots would all have sorted behind them. The
(tile, depth) order comes from one int64 key, tile << 32 | sortable(depth),
sorted with `torch.sort(stable=True)`: exact depth ties keep slot order.
(The JAX package's `lax.sort(num_keys=2)` is not stable, so exact depth
ties may order differently there.)
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import RenderConfig
from .projection import ProjectedSplats


@dataclasses.dataclass
class TileBins:
    """Sorted splat→tile assignment.

    sorted_gidx: [M] int32 gaussian id of each (tile, depth)-sorted live
                 pair, M = min(live pairs, gather cap).
    sorted_slot: [N·max_dup] int64, the full sort permutation: position →
                 originating slot id (k·N + g), live pairs in sorted order
                 and then the dead slots ascending. The backward pass sorts
                 pair gradients back into slot order with it.
    tile_start:  [T] int32 offset of each tile's segment in the pairs.
    tile_count:  [T] int32 segment length per tile.
    num_pairs:   [] int64 live pairs kept (observability).
    overflow:    [] int64 gaussians whose footprint was shrunk to max_dup
                 tiles, plus live pairs cut by the gather cap.
    """

    sorted_gidx: torch.Tensor
    sorted_slot: torch.Tensor
    tile_start: torch.Tensor
    tile_count: torch.Tensor
    num_pairs: torch.Tensor
    overflow: torch.Tensor


def float_to_sortable_uint(f: torch.Tensor) -> torch.Tensor:
    """Monotone float32 → uint32 key (as int64 in [0, 2³²)): flip the sign
    bit of positives, complement all bits of negatives."""
    bits = f.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    u = bits & 0xFFFFFFFF
    return torch.where(bits < 0, u ^ 0xFFFFFFFF, u ^ 0x80000000)


def _cutoff_tau(opacity: torch.Tensor, config: RenderConfig) -> torch.Tensor:
    """Level-set threshold τ: alpha ≥ cutoff ⟺ ½ dᵀΣ⁻¹d ≤ τ."""
    return torch.log(
        torch.clamp(opacity, min=config.alpha_cutoff) / config.alpha_cutoff
    )


def _footprints(splats: ProjectedSplats, width: int, height: int,
                config: RenderConfig):
    """Per-gaussian tile rects (x0, y0, rw, rh), int32: INRIA getRect
    tightened to the per-axis extents of the cutoff ellipse,
    rx = √(2τΣxx) + ½, ry = √(2τΣyy) + ½. Invalid means sit at −1e6."""
    ts = config.tile_size
    gx, gy = config.grid_size(width, height)
    valid = splats.valid
    mean = torch.where(valid[:, None], splats.mean2d,
                       torch.full_like(splats.mean2d, -1e6))
    zero = torch.zeros_like(splats.radius)
    if config.radius_sigma > 0:
        rx = ry = splats.radius
    else:
        qa, qb, qc = splats.conic.unbind(-1)
        det_q = torch.clamp(qa * qc - qb * qb, min=1e-24)
        tau = _cutoff_tau(splats.opacity, config)
        rx = torch.sqrt(2.0 * tau * qc / det_q) + 0.5
        ry = torch.sqrt(2.0 * tau * qa / det_q) + 0.5
        rx = torch.where(valid, torch.minimum(rx, splats.radius), zero)
        ry = torch.where(valid, torch.minimum(ry, splats.radius), zero)

    def edge(v, n):
        return torch.clamp(v, 0, n).to(torch.int32)

    x0 = edge(torch.floor((mean[:, 0] - rx) / ts), gx)
    y0 = edge(torch.floor((mean[:, 1] - ry) / ts), gy)
    x1 = edge(torch.floor((mean[:, 0] + rx) / ts) + 1, gx)
    y1 = edge(torch.floor((mean[:, 1] + ry) / ts) + 1, gy)
    zi = torch.zeros_like(x0)
    rw = torch.where(valid, x1 - x0, zi)
    rh = torch.where(valid, y1 - y0, zi)
    return x0, y0, rw, rh


def _shrink_oversized(x0, y0, rw, rh, d: int):
    """Shrink rects of more than d tiles around their centre by √(d/ntg)
    (JAX `sort.py:497-510`, reproduced with its known defect: it centres on
    the screen-clipped rect, with a half-tile bias). Returns the new rect
    and the mask of shrunk gaussians."""
    ntg_raw = rw * rh
    over = ntg_raw > d
    sf = torch.sqrt(d / torch.clamp(ntg_raw, min=1).to(torch.float32))
    rw2 = torch.clamp(torch.floor(rw.to(torch.float32) * sf).to(torch.int32),
                      1, d)
    rh_cap = torch.clamp(d // torch.clamp(rw2, min=1), min=1)
    rh2 = torch.minimum(
        torch.clamp(torch.floor(rh.to(torch.float32) * sf).to(torch.int32),
                    min=1),
        rh_cap)
    x0 = torch.where(over, x0 + (rw - rw2) // 2, x0)
    y0 = torch.where(over, y0 + (rh - rh2) // 2, y0)
    rw = torch.where(over, rw2, rw)
    rh = torch.where(over, rh2, rh)
    return x0, y0, rw, rh, over


def candidate_slot_tiles(x0, y0, rw, ntg, d: int, gx: int, num_tiles: int):
    """Slot-major [d, N] grid: slot k → k-th tile of the rect (row-major).
    Returns (tile [d, N] int32 with `num_tiles` as the dead sentinel,
    live [d, N] bool)."""
    slot = torch.arange(d, dtype=torch.int32, device=x0.device)[:, None]
    live = slot < ntg[None, :]
    safe_rw = torch.clamp(rw, min=1)[None, :]
    ty = y0[None, :] + slot // safe_rw
    tx = x0[None, :] + slot % safe_rw
    tile = torch.where(live, ty * gx + tx,
                       torch.full_like(tx, num_tiles))
    return tile, live


def bin_splats(
    splats: ProjectedSplats,
    width: int,
    height: int,
    config: RenderConfig,
) -> TileBins:
    """Bin projected splats into depth-sorted per-tile segments."""
    gx, gy = config.grid_size(width, height)
    num_tiles = gx * gy
    n = splats.depth.shape[0]
    d = config.max_dup

    x0, y0, rw, rh = _footprints(splats, width, height, config)
    x0, y0, rw, rh, over = _shrink_oversized(x0, y0, rw, rh, d)
    ntg = torch.clamp(rw * rh, max=d)
    tile, live = candidate_slot_tiles(x0, y0, rw, ntg, d, gx, num_tiles)

    live_flat = live.reshape(-1)
    live_slot = torch.nonzero(live_flat).squeeze(1)       # ascending slot ids
    pair_tile = tile.reshape(-1)[live_slot].to(torch.int64)
    pair_gidx = live_slot % n
    key = (pair_tile << 32) | float_to_sortable_uint(splats.depth[pair_gidx])
    sorted_key, order = torch.sort(key, stable=True)
    sorted_live_slot = live_slot[order]
    sorted_gidx = (sorted_live_slot % n).to(torch.int32)
    dead_slot = torch.nonzero(~live_flat).squeeze(1)
    sorted_slot = torch.cat([sorted_live_slot, dead_slot])

    tile_count = torch.bincount(sorted_key >> 32, minlength=num_tiles)
    tile_start = torch.cumsum(tile_count, 0) - tile_count
    num_pairs = live_slot.new_tensor(live_slot.shape[0])
    overflow = over.sum().to(torch.int64)

    if config.gather_cap_factor > 0:
        # JAX sort.py:421-444: cut the sorted pairs at factor·N (never
        # below the floor); past the cap the farthest tiles lose their
        # deepest splats, counted in overflow
        cap = min(n * d, max(int(n * config.gather_cap_factor),
                             config.gather_cap_floor))
        sorted_gidx = sorted_gidx[:cap]
        tile_count = torch.minimum(tile_count,
                                   torch.clamp(cap - tile_start, min=0))
        tile_start = torch.clamp(tile_start, max=cap)
        overflow = overflow + torch.clamp(num_pairs - cap, min=0)
        num_pairs = torch.clamp(num_pairs, max=cap)

    return TileBins(
        sorted_gidx=sorted_gidx,
        sorted_slot=sorted_slot,
        tile_start=tile_start.to(torch.int32),
        tile_count=tile_count.to(torch.int32),
        num_pairs=num_pairs,
        overflow=overflow,
    )
