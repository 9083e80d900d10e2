"""Tile binning: depth-ordered per-tile splat segments, the port of the
JAX package's `ops/sort.py::bin_splats` in all its modes.

Each gaussian owns candidate slots in slot-major [w, R] grids; slot k holds
the k-th tile of its footprint rect in row-major order. Single-tier
(`tier_split=0`) gives every gaussian `max_dup` slots, slot id k·N + g.
Tiered duplication (`tier_split > 0`) gives every gaussian d_a =
min(tier_split, max_dup) slots and compacts the gaussians with bigger
footprints, in ascending id by a stable class sort, into tiers of width
`tier_mid` (optional) and `max_dup`, each capped at a fraction of N
(`mid_frac`, `big_frac`, at least 256 rows); the splats past a tier's cap
get no pairs and count in `overflow`. Tier j's [w_j, cap_j] block follows
tier A's, slot off_j + k·cap_j + r. With `tile_cull` (and `radius_sigma
<= 0`) a slot whose tile the cutoff ellipse misses is dead.

The JAX package sorts the whole slot array, dead slots carrying the
sentinel tile so they sort last. Here the live slots are compacted first
(`nonzero`, ascending slot ids), which changes no live position because the
dead slots would all have sorted behind them. The (tile, depth) order comes
from one key sorted with `torch.sort(stable=True)`: tile << 32 |
sortable(depth) in the exact mode, and with `depth_bits > 0` JAX's packed
32-bit key tile << b | sortable(depth) >> (32 − b), b = min(depth_bits,
32 − bit_length(T + 1)). Ties keep slot order; the JAX package's
`lax.sort` is not stable, so tied pairs may order differently there (with
the packed key, pairs whose depths agree in their top b bits tie).

`bin_splats` runs the CUDA kernels of `csrc/bin.cu` (`ops/cuda/bin.py`) for
CUDA tensors with single-tier duplication, and `bin_splats_plain`, the
PyTorch ops below, for CPU tensors and the tiered modes; both give the same
bins bit for bit on the same tensors.

Binning reads the unrounded projected splats; `quantize_bf16` and
`quantize_mean16` are the roundings `pack_fields` and `pack_mean16` apply
to the compositor's fields afterwards (straight-through gradients, as the
JAX package's `custom_jvp` rules).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..config import RenderConfig
from ..utils import tracing
from .cuda import runs_kernels
from .projection import ProjectedSplats

TAU_SLACK = 1e-3      # slack on the cull's level-set threshold (JAX sort.py)
MEAN16_SCALE = 32.0   # pack_mean16: 1/32-px fixed point ...
MEAN16_OFF = 1024.0   # ... over [-1024, 1024) px from the tile origin


@dataclasses.dataclass
class TileBins:
    """Sorted splat→tile assignment.

    sorted_gidx: [M] int32 gaussian id of each (tile, depth)-sorted live
                 pair, M = min(live pairs, gather cap).
    sorted_slot: [S] int64, the full sort permutation over all S slots:
                 position → originating slot id, live pairs in sorted order
                 and then the dead slots ascending. The backward pass puts
                 pair gradients back into slot order with it.
    tile_start:  [T] int32 offset of each tile's segment in the pairs.
    tile_count:  [T] int32 segment length per tile.
    num_pairs:   [] int64 live pairs kept (observability).
    overflow:    [] int64 gaussians whose footprint was shrunk to max_dup
                 tiles, plus splats past a compacted tier's cap, plus live
                 pairs cut by the gather cap.
    tier_a_width: slots per gaussian in tier A (0: S // N, single tier).
    comp_widths: slot widths of the compacted tiers, ascending (() when
                 single-tier).
    comp_idx:    per compacted tier, [cap_j] int64 row → gaussian id
                 (ascending; rows past the tier's count point at 0).
    comp_count:  per compacted tier, [] int64 gaussians of its class (its
                 first min(count, cap_j) rows are real).
    """

    sorted_gidx: torch.Tensor
    sorted_slot: torch.Tensor
    tile_start: torch.Tensor
    tile_count: torch.Tensor
    num_pairs: torch.Tensor
    overflow: torch.Tensor
    tier_a_width: int = 0
    comp_widths: Tuple[int, ...] = ()
    comp_idx: Tuple[torch.Tensor, ...] = ()
    comp_count: Tuple[torch.Tensor, ...] = ()


class _QuantizeBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class _QuantizeMean16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rel):
        q = torch.clamp(torch.round((rel + MEAN16_OFF) * MEAN16_SCALE),
                        0.0, 65535.0)
        return q * (1.0 / MEAN16_SCALE) - MEAN16_OFF

    @staticmethod
    def backward(ctx, g):
        return g


def quantize_bf16(x: torch.Tensor) -> torch.Tensor:
    """bf16 round trip (round to nearest even) with a straight-through
    gradient (JAX `ops/sort.py::quantize_bf16`)."""
    return _QuantizeBf16.apply(x)


def quantize_mean16(rel: torch.Tensor) -> torch.Tensor:
    """The tile-relative mean's 1/32-px round trip, clip(round((rel +
    1024)·32), 0, 65535)/32 − 1024, round half to even, with a
    straight-through gradient (JAX `ops/sort.py::quantize_mean16`)."""
    return _QuantizeMean16.apply(rel)


def mean16_on(config: RenderConfig) -> bool:
    """`pack_mean16` acts only with `pack_fields` (JAX sort.py:554-555)."""
    return bool(config.pack_fields and config.pack_mean16)


def float_to_sortable_uint(f: torch.Tensor) -> torch.Tensor:
    """Monotone float32 → uint32 key (as int64 in [0, 2³²)): flip the sign
    bit of positives, complement all bits of negatives."""
    bits = f.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    u = bits & 0xFFFFFFFF
    return torch.where(bits < 0, u ^ 0xFFFFFFFF, u ^ 0x80000000)


def depth_sort_indices(depth: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Global front-to-back order by view depth (the reference's whole
    per-frame sort, renderer.ts:301-315): a stable argsort, invalid splats
    last. `jnp.argsort` is stable too, so ties order alike."""
    key = torch.where(valid, depth, torch.full_like(depth, float("inf")))
    return torch.sort(key, stable=True).indices


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


def _rect_quad_min(qa, qb, qc, dx0, dx1, dy0, dy1):
    """Exact min of q(d) = ½(A dx² + 2B dx dy + C dy²) over the rectangle
    [dx0, dx1] × [dy0, dy1] for a positive-definite (A, B, C): 0 when the
    rectangle holds the centre, else the least of the four edges' minima
    (JAX `sort.py::_rect_quad_min`, in its f32 operation order)."""
    inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)
    safe_a = torch.clamp(qa, min=1e-12)
    safe_c = torch.clamp(qc, min=1e-12)

    def edge_x(e):           # dx fixed at e, minimise over dy
        y = torch.minimum(torch.maximum(-qb * e / safe_c, dy0), dy1)
        return 0.5 * qa * e * e + qb * e * y + 0.5 * qc * y * y

    def edge_y(e):           # dy fixed at e, minimise over dx
        x = torch.minimum(torch.maximum(-qb * e / safe_a, dx0), dx1)
        return 0.5 * qc * e * e + qb * e * x + 0.5 * qa * x * x

    q = torch.minimum(torch.minimum(edge_x(dx0), edge_x(dx1)),
                      torch.minimum(edge_y(dy0), edge_y(dy1)))
    return torch.where(inside, 0.0, q)


def candidate_slot_tiles(x0, y0, rw, ntg, d: int, gx: int, num_tiles: int,
                         ts: int = 16, rows=None):
    """Slot-major [d, R] grid: slot k → k-th tile of the rect (row-major).
    With `rows` = (mx, my, A, B, C, τ) per splat, a slot whose tile
    rectangle the cutoff ellipse misses (min q > τ + TAU_SLACK) is dead
    (`tile_cull`, JAX `sort.py:307-340`). Returns (tile [d, R] int32 with
    `num_tiles` as the dead sentinel, live [d, R] bool)."""
    slot = torch.arange(d, dtype=torch.int32, device=x0.device)[:, None]
    live = slot < ntg[None, :]
    safe_rw = torch.clamp(rw, min=1)[None, :]
    ty = y0[None, :] + slot // safe_rw
    tx = x0[None, :] + slot % safe_rw
    if rows is not None:
        mx, my, qa, qb, qc, tau = (r[None, :] for r in rows)
        dx0 = tx.to(torch.float32) * ts - mx
        dy0 = ty.to(torch.float32) * ts - my
        qmin = _rect_quad_min(qa, qb, qc, dx0, dx0 + (ts - 1), dy0,
                              dy0 + (ts - 1))
        live = live & (qmin <= tau + TAU_SLACK)
    tile = torch.where(live, ty * gx + tx,
                       torch.full_like(tx, num_tiles))
    return tile, live


def tier_widths(n: int, config: RenderConfig):
    """(d_a, [(w_j, cap_j)]) of the duplication tiers (JAX
    `sort.py:575-588`): single-tier gives (max_dup, [])."""
    d = config.max_dup
    d_a = min(config.tier_split, d) if config.tier_split > 0 else d
    if d_a >= d:
        return d, []
    widths = []
    if d_a < config.tier_mid < d:
        widths.append((config.tier_mid,
                       max(min(int(n * config.mid_frac), n), 256)))
    widths.append((d, max(min(int(n * config.big_frac), n), 256)))
    return d_a, widths


def sort_key_bits(num_tiles: int, config: RenderConfig) -> int:
    """Depth bits of the packed key (0: the exact int64 key), JAX
    `sort.py:362-365`."""
    tile_bits = max(int(num_tiles + 1).bit_length(), 1)
    return max(min(config.depth_bits, 32 - tile_bits), 0)


def gather_cap(n: int, slots: int, config: RenderConfig) -> int:
    """Sorted pairs kept (JAX sort.py:421-444): factor·N, never below the
    floor, never above the slots; every slot without a factor."""
    if config.gather_cap_factor <= 0:
        return slots
    return min(slots, max(int(n * config.gather_cap_factor),
                          config.gather_cap_floor))


def takes_kernels(device: torch.device, config: RenderConfig) -> bool:
    """Whether `bin_splats` runs csrc/bin.cu (`ops/cuda/bin.py`): CUDA
    tensors with single-tier duplication. CPU tensors and the tiered modes
    take `bin_splats_plain`; any other device raises."""
    return runs_kernels(device, "binning") and not tier_widths(0, config)[1]


@tracing.spanned("binning")
@torch.no_grad()
def bin_splats(
    splats: ProjectedSplats,
    width: int,
    height: int,
    config: RenderConfig,
) -> TileBins:
    """Bin projected splats into depth-sorted per-tile segments (no
    gradient flows through binning); see the module docstring. CUDA tensors
    with single-tier duplication take the CUDA kernels, the same bins bit
    for bit; the rest takes `bin_splats_plain`."""
    if takes_kernels(splats.depth.device, config):
        from .cuda.bin import bin_splats_cuda

        return bin_splats_cuda(splats, width, height, config)
    return bin_splats_plain(splats, width, height, config)


@torch.no_grad()
def bin_splats_plain(
    splats: ProjectedSplats,
    width: int,
    height: int,
    config: RenderConfig,
) -> TileBins:
    """`bin_splats` in PyTorch ops, on any device, in every mode."""
    gx, gy = config.grid_size(width, height)
    num_tiles = gx * gy
    n = splats.depth.shape[0]
    d = config.max_dup
    ts = config.tile_size
    dev = splats.depth.device

    x0, y0, rw, rh = _footprints(splats, width, height, config)
    x0, y0, rw, rh, over = _shrink_oversized(x0, y0, rw, rh, d)
    ntg = rw * rh                                   # at most d after the shrink
    rows = None
    if config.tile_cull and config.radius_sigma <= 0:
        rows = (splats.mean2d[:, 0], splats.mean2d[:, 1],
                splats.conic[:, 0], splats.conic[:, 1], splats.conic[:, 2],
                _cutoff_tau(splats.opacity, config))

    d_a, widths = tier_widths(n, config)
    tile_a, live_a = candidate_slot_tiles(
        x0, y0, rw, torch.where(ntg > d_a, 0, ntg), d_a, gx, num_tiles, ts,
        rows)
    tiles, lives = [tile_a], [live_a]
    gidxs = [torch.arange(n, device=dev).expand(d_a, n)]
    overflow = over.sum().to(torch.int64)
    comp_idx, comp_count = [], []
    if widths:
        # the stable class sort of JAX sort.py:601-622: class j holds the
        # gaussians whose footprint exceeds the previous width and fits w_j
        cls = torch.full((n,), len(widths), dtype=torch.int64, device=dev)
        prev = d_a
        for j, (w_j, _) in enumerate(widths):
            sel = ntg > prev
            if w_j != d:
                sel = sel & (ntg <= w_j)
            cls = torch.where(sel, j, cls)
            prev = w_j
        perm = torch.sort(cls, stable=True).indices
        counts = torch.bincount(cls, minlength=len(widths) + 1)
        perm = torch.cat([perm, perm.new_zeros(max(c for _, c in widths))])
        offset = counts.new_zeros(())
        for j, (w_j, cap_j) in enumerate(widths):
            r = torch.arange(cap_j, device=dev)
            valid = r < counts[j]
            idx = torch.where(valid, perm[offset + r], 0)
            offset = offset + counts[j]
            ntg_j = torch.where(valid, torch.clamp(ntg[idx], max=w_j), 0)
            tile_j, live_j = candidate_slot_tiles(
                x0[idx], y0[idx], rw[idx], ntg_j, w_j, gx, num_tiles, ts,
                None if rows is None else tuple(c[idx] for c in rows))
            tiles.append(tile_j)
            lives.append(live_j)
            gidxs.append(idx.expand(w_j, cap_j))
            overflow = overflow + torch.clamp(counts[j] - cap_j, min=0)
            comp_idx.append(idx)
            comp_count.append(counts[j])

    # slot id = position in the concatenation of the flattened tier blocks
    tile = torch.cat([t.reshape(-1) for t in tiles])
    live_flat = torch.cat([lv.reshape(-1) for lv in lives])
    live_slot = torch.nonzero(live_flat).squeeze(1)       # ascending slot ids
    pair_tile = tile[live_slot].to(torch.int64)
    if widths:
        pair_gidx = torch.cat([g.reshape(-1) for g in gidxs])[live_slot]
    else:
        pair_gidx = live_slot % n
    shift = sort_key_bits(num_tiles, config) or 32   # exact: all 32 bits
    dkey = float_to_sortable_uint(splats.depth[pair_gidx]) >> (32 - shift)
    sorted_key, order = torch.sort((pair_tile << shift) | dkey, stable=True)
    sorted_live_slot = live_slot[order]
    sorted_gidx = pair_gidx[order].to(torch.int32)
    dead_slot = torch.nonzero(~live_flat).squeeze(1)
    sorted_slot = torch.cat([sorted_live_slot, dead_slot])

    tile_count = torch.bincount(sorted_key >> shift, minlength=num_tiles)
    tile_start = torch.cumsum(tile_count, 0) - tile_count
    kept = live_slot.shape[0]
    num_pairs = live_slot.new_tensor(kept)

    if config.gather_cap_factor > 0:
        # JAX sort.py:421-444: cut the sorted pairs at factor·N (never
        # below the floor, never above the slots); past the cap the
        # farthest tiles lose their deepest splats, counted in overflow
        cap = gather_cap(n, tile.shape[0], config)
        sorted_gidx = sorted_gidx[:cap]
        tile_count = torch.minimum(tile_count,
                                   torch.clamp(cap - tile_start, min=0))
        tile_start = torch.clamp(tile_start, max=cap)
        overflow = overflow + torch.clamp(num_pairs - cap, min=0)
        num_pairs = torch.clamp(num_pairs, max=cap)
        kept = min(kept, cap)

    tracing.count("binning.live_pairs", kept)
    tracing.count("binning.slots", tile.shape[0])

    return TileBins(
        sorted_gidx=sorted_gidx,
        sorted_slot=sorted_slot,
        tile_start=tile_start.to(torch.int32),
        tile_count=tile_count.to(torch.int32),
        num_pairs=num_pairs,
        overflow=overflow,
        tier_a_width=d_a,
        comp_widths=tuple(w for w, _ in widths),
        comp_idx=tuple(comp_idx),
        comp_count=tuple(comp_count),
    )
