"""Anchor-tile binning and the plain PyTorch versions of the anchor
compositor's kernels C and D: the port of the JAX package's
`ops/pallas/anchor.py`, in its exact mode (`pack_fields=False`) and its
packed mode (`pack_fields=True`).

Binning (`bin_splats_anchor`, JAX `anchor.py:105-311`):
  * a live splat whose footprint fits a 2×2-tile window (`ANCHOR_W`) is
    "small" and gets ONE entry, at its top-left (anchor) tile; its meta
    says whether it extends to the right (wide, bit 2) and down (tall,
    bit 1); its slot is its gaussian id;
  * the other live splats ("big") are compacted, in index order, up to
    `cap_b`; each gets at most `max_dup` entries, the first tiles of its
    rect in row-major order (no centre shrink), meta 4 ("dup": touches
    exactly its own tile), slot N + k·cap_b + j;
  * all N + max_dup·cap_b entries sort by (tile, depth); dead entries take
    the sentinel tile T and sort last. Like the dup binning
    (`ops/sort.py`), the order comes from one stable `torch.sort` of an
    int64 key, so tied keys keep slot order (the JAX package's `lax.sort`
    is not stable). The exact mode's key is tile << 32 | sortable(depth);
    the packed mode's is JAX's tile << 16 | d16, d16 = `depth16`, a 16-bit
    depth on the [min, max] depth range of the live splats (a dup entry
    takes its splat's d16), and then `sorted_depth` holds d16, so the
    merge below ranks by (d16, union lane): JAX's packed order key
    d16·mult + lane. The packed mode needs fewer than 65,536 tiles
    (`ops/rasterize.py::uses_anchor` falls back to the dup binning).

Merge (`merge_tiles`, the twin of `_merge_tile` :431 and `_TileScalars`
:380, vectorised over tiles): tile (tx, ty) reads two contiguous ranges of
the sorted entries, A = anchor tiles (tx−1..tx) of row ty−1 and B = the
same columns of row ty, each only as far as its aligned cover reaches
(`c_max` chunks of 256 from its first position rounded down to 256;
positions past it are dropped). Entries that touch the tile (range B: dup
entries in column tx, anchors in column tx or wide; range A: tall anchors
in column tx or wide) rank by (sortable depth, union lane), the union lane
being q·256 + lane with range B's lanes after range A's, and the first
`k_cap` are kept. The sort is stable and a range's two runs ascend in
(key, position), so the keys are unique and the merge needs no tie rule.

The compositing of the ordered list, forward and backward, is the dup
path's plain compositor (`ops/rasterize.py`) run over an ordered view of
the entries, and `fold_anchor_grads` sums the backward's four row groups
and folds them onto the splats (`ops/pallas/raster.py::_fold_pair_grads`
over the anchor bins, rounding the rows to bf16 with `pack_grads`). The
packed mode's fields are bf16-rounded by `pack_splat_fields`; the anchor
compositor never applies `pack_mean16` (JAX's anchor slab carries the f32
mean).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..config import RenderConfig
from ..utils import tracing
from .projection import ProjectedSplats
from .rasterize import (
    GRAD_ROW,
    Composite,
    composite_backward_plain,
    composite_image_plain,
)
from .sort import (
    TileBins,
    _footprints,
    candidate_slot_tiles,
    float_to_sortable_uint,
    quantize_bf16,
)

KCL = 256       # positions per cover chunk of a range
ANCHOR_W = 2    # tier-A footprint window, tiles per axis
MERGE_ELEMS = 1 << 22   # bound on tiles·union lanes per plain-merge chunk


def c_max(config: RenderConfig) -> int:
    """Cover chunks per range (JAX `anchor.py::_c_max`)."""
    return config.max_per_tile // KCL + 2


def k_cap(config: RenderConfig) -> int:
    """Entries kept per tile (JAX `raster.py::k_cap_for`)."""
    return max(KCL, -(-config.max_per_tile // KCL) * KCL)


@dataclasses.dataclass
class AnchorBins:
    """Anchor-sorted entries, M = N + max_dup·cap_b of them.

    starts:       [T+1] int32 segment start of every anchor tile (row-major);
                  starts[T] = live entries.
    sorted_gidx:  [M] int32 gaussian id of each sorted entry.
    sorted_meta:  [M] uint8, 1 = tall, 2 = wide, 4 = dup entry.
    sorted_depth: [M] int32 holding the uint32 sortable depth bits (the
                  packed mode: d16).
    sorted_slot:  [M] int64, position → slot (a permutation of M).
    idx_b:        [cap_b] int64 the compacted big splats (0 past n_big).
    n_big, num_pairs, overflow: [] int64 counts.
    """

    starts: torch.Tensor
    sorted_gidx: torch.Tensor
    sorted_meta: torch.Tensor
    sorted_depth: torch.Tensor
    sorted_slot: torch.Tensor
    idx_b: torch.Tensor
    n_big: torch.Tensor
    num_pairs: torch.Tensor
    overflow: torch.Tensor


class Merge(NamedTuple):
    """Per-tile ordered candidate lists: entry positions [T, k_cap] int32
    (−1 past k_used), k_used [T] int32, and each kept entry's backward row
    group [T, k_cap] int8 = range row type (A 0, B 1) · 2 + tx mod 2."""

    ordered: torch.Tensor
    k_used: torch.Tensor
    group: torch.Tensor


class Ranges(NamedTuple):
    """Per tile and range (A, B): [T, 2] int64 first position `s0`, column
    split `sb`, end `s1`, and the aligned cover's `base`."""

    s0: torch.Tensor
    sb: torch.Tensor
    s1: torch.Tensor
    base: torch.Tensor


def depth16(depth: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """The packed mode's 16-bit depth on the dynamic [min, max] depth range
    of the live splats, front to back ascending, as int64 (JAX
    `anchor.py::_depth16`, in its f32 operations); 0 where not live."""
    if depth.numel() == 0:
        return torch.zeros_like(depth, dtype=torch.int64)
    big = 3.4e38
    lo = torch.where(live, depth, big).min()
    hi = torch.where(live, depth, -big).max()
    # a true f32 division: `float / tensor` multiplies by the reciprocal
    scale = torch.div(depth.new_tensor(65535.0),
                      torch.clamp(hi - lo, min=1e-20))
    d = torch.clamp((depth - lo) * scale, 0.0, 65535.0)
    return torch.where(live, d, 0.0).to(torch.int64)


@tracing.spanned("binning")
@torch.no_grad()
def bin_splats_anchor(splats: ProjectedSplats, width: int, height: int,
                      config: RenderConfig) -> AnchorBins:
    """Anchor-tile binning, exact or packed by `config.pack_fields` (no
    gradient flows through it); see the module docstring."""
    gx, gy = config.grid_size(width, height)
    num_tiles = gx * gy
    packed = bool(config.pack_fields)
    if packed and num_tiles >= (1 << 16):
        raise ValueError(
            f"anchor binning packs tile ids in 16 bits; {num_tiles} tiles "
            "needs the exact mode (pack_fields=False) or the dup binning")
    n = splats.depth.shape[0]
    d = config.max_dup
    dev = splats.depth.device

    x0, y0, rw, rh = _footprints(splats, width, height, config)
    ntg = rw * rh
    live = splats.valid & (ntg > 0)
    small = live & (rw <= ANCHOR_W) & (rh <= ANCHOR_W)
    big = live & ~small
    if packed:
        depth_key, shift = depth16(splats.depth, live), 16
    else:
        depth_key, shift = float_to_sortable_uint(splats.depth), 32

    tile_a = torch.where(small, y0.long() * gx + x0, num_tiles)
    meta_a = (rw > 1).to(torch.uint8) * 2 + (rh > 1).to(torch.uint8)

    cap_b = max(min(int(n * config.big_frac), n), 256)
    big_ids = torch.nonzero(big).squeeze(1)     # the stable class sort
    n_big = big_ids.shape[0]
    idx_b = torch.zeros(cap_b, dtype=torch.int64, device=dev)
    idx_b[:min(n_big, cap_b)] = big_ids[:cap_b]
    valid_b = torch.arange(cap_b, device=dev) < n_big
    ntg_b = torch.where(valid_b, torch.clamp(ntg[idx_b], max=d), 0)
    tile_b, live_b = candidate_slot_tiles(x0[idx_b], y0[idx_b], rw[idx_b],
                                          ntg_b, d, gx, num_tiles)

    overflow = (torch.where(big, torch.clamp(ntg - d, min=0), 0).sum()
                + max(n_big - cap_b, 0))
    num_pairs = (torch.where(small, ntg, 0).sum().to(torch.int64)
                 + live_b.sum())

    # entry i of the concatenation is slot i: N anchors, then [d, cap_b]
    tile = torch.cat([tile_a, tile_b.reshape(-1).long()])
    dkey = torch.cat([depth_key,
                      depth_key[idx_b].expand(d, cap_b).reshape(-1)])
    _, order = torch.sort((tile << shift) | dkey, stable=True)
    gid = torch.cat([torch.arange(n, device=dev),
                     idx_b.expand(d, cap_b).reshape(-1)])
    meta = torch.cat([meta_a, torch.full((d * cap_b,), 4, dtype=torch.uint8,
                                         device=dev)])
    sdepth = dkey[order]
    starts = torch.searchsorted(
        tile[order], torch.arange(num_tiles + 1, device=dev))
    return AnchorBins(
        starts=starts.to(torch.int32),
        sorted_gidx=gid[order].to(torch.int32),
        sorted_meta=meta[order],
        sorted_depth=(sdepth - ((sdepth >> 31) << 32)).to(torch.int32),
        sorted_slot=order,
        idx_b=idx_b,
        n_big=torch.tensor(n_big, device=dev),
        num_pairs=num_pairs,
        overflow=overflow,
    )


def tile_ranges(abins: AnchorBins, gx: int, gy: int,
                config: RenderConfig) -> Ranges:
    """The two ranges of every tile (JAX `_TileScalars`). Range A is empty
    on row 0; column tx−1 is empty at tx = 0."""
    dev = abins.starts.device
    num_tiles = gx * gy
    t = torch.arange(num_tiles, device=dev)
    tx, ty = t % gx, t // gx
    st = abins.starts.long()
    cols = [torch.clamp(tx - 1, min=0), tx, tx + 1]
    out = []
    for row, has in ((ty - 1, ty > 0), (ty, torch.ones_like(ty, dtype=bool))):
        s = [torch.where(has, st[torch.clamp(row * gx + c, 0, num_tiles)], 0)
             for c in cols]
        out.append(s + [s[0] // KCL * KCL])
    return Ranges(*(torch.stack([a, b], 1) for a, b in zip(*out)))


def cover_lengths(abins: AnchorBins, gx: int, gy: int,
                  config: RenderConfig) -> torch.Tensor:
    """[T, 2] int64 positions each range of each tile reads: from its first
    position to its end clipped at the aligned cover."""
    rng = tile_ranges(abins, gx, gy, config)
    end = torch.minimum(rng.s1, rng.base + c_max(config) * KCL)
    return torch.clamp(end - rng.s0, min=0)


def _candidates(abins: AnchorBins, gx: int, gy: int, config: RenderConfig):
    """Kernel C's touch rule, a chunk of tiles at a time → (slice, pos,
    touch): each tile's union lanes [C, 2·half] (range A's c_max·KCL lanes,
    then range B's) as sorted positions clamped into the entries, and
    whether each is a touched candidate."""
    num_tiles = gx * gy
    half = c_max(config) * KCL
    rng = tile_ranges(abins, gx, gy, config)
    end = torch.minimum(rng.s1, rng.base + half)
    m = abins.sorted_gidx.shape[0]
    lane = torch.arange(2 * half, device=abins.starts.device)
    r = lane // half                                   # 0 = A, 1 = B
    chunk = max(1, MERGE_ELEMS // (2 * half))
    for t0 in range(0, num_tiles, chunk):
        sl = slice(t0, t0 + chunk)
        pos = rng.base[sl][:, r] + lane % half         # [C, 2·half]
        in_rng = (pos >= rng.s0[sl][:, r]) & (pos < end[sl][:, r])
        safe = torch.clamp(pos, 0, max(m - 1, 0))
        meta = abins.sorted_meta[safe].to(torch.int32)
        dup, wide, tall = (meta & 4) > 0, (meta & 2) > 0, (meta & 1) > 0
        own_col = pos >= rng.sb[sl][:, r]
        ok_col = own_col | wide
        touch_b = torch.where(dup, own_col, ok_col)
        touch_a = ~dup & ok_col & tall
        yield sl, safe, in_rng & torch.where(r == 1, touch_b, touch_a)


def touched_counts(abins: AnchorBins, gx: int, gy: int,
                   config: RenderConfig) -> torch.Tensor:
    """[T] int64 touched candidates of each tile's two ranges before the
    k_cap cut: the union positions whose depth kernel C's merge loads."""
    return torch.cat([touch.sum(1) for _, _, touch in
                      _candidates(abins, gx, gy, config)])


def split_overruns(abins: AnchorBins, gx: int, gy: int,
                   config: RenderConfig) -> torch.Tensor:
    """[T] bool, for the kernel checks: the tiles whose range A splits its
    columns past its cover's end (column tx−1 of row ty−1 holds more
    entries than the cover has left) while range B holds touched
    candidates in the union lanes below that split, where kernel C's run
    bounds must stop at range A's end."""
    half = c_max(config) * KCL
    rng = tile_ranges(abins, gx, gy, config)
    past = rng.sb[:, 0] - rng.base[:, 0] - half
    lanes = torch.arange(half, device=abins.starts.device)
    return torch.cat([(touch[:, half:] & (lanes < past[sl, None])).any(1)
                      for sl, _, touch in _candidates(abins, gx, gy, config)])


def merge_tiles(abins: AnchorBins, gx: int, gy: int,
                config: RenderConfig) -> Merge:
    """The plain version of kernel C's merge: per tile, the first k_cap
    touched candidates of its two ranges in (depth, union lane) order."""
    dev = abins.starts.device
    num_tiles = gx * gy
    half = c_max(config) * KCL
    kc = k_cap(config)
    lane = torch.arange(2 * half, device=dev)
    r = lane // half                                   # 0 = A, 1 = B
    ordered = torch.full((num_tiles, kc), -1, dtype=torch.int32, device=dev)
    group = torch.zeros((num_tiles, kc), dtype=torch.int8, device=dev)
    k_used = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
    for sl, pos, touch in _candidates(abins, gx, gy, config):
        # (uint32 depth − 2³¹) << 32 | lane: the uint64 order in an int64
        depth = abins.sorted_depth[pos].long() & 0xFFFFFFFF
        hi = torch.where(touch, depth, 0xFFFFFFFF) - (1 << 31)
        key = (hi << 32) | lane
        _, idx = torch.sort(key, dim=1)
        idx = idx[:, :kc]
        kept = torch.arange(kc, device=dev) < torch.clamp(
            touch.sum(1), max=kc)[:, None]
        tx = torch.arange(sl.start, sl.start + idx.shape[0], device=dev) % gx
        ordered[sl] = torch.where(kept, pos.gather(1, idx), -1).to(torch.int32)
        group[sl] = torch.where(kept, r[idx] * 2 + tx[:, None] % 2,
                                0).to(torch.int8)
        k_used[sl] = kept.sum(1).to(torch.int32)
    return Merge(ordered, k_used, group)


def ordered_view(abins: AnchorBins, merge: Merge,
                 config: RenderConfig) -> Tuple[TileBins, RenderConfig]:
    """The ordered lists as dup-path bins (segment t = t·k_cap, k_used
    long) and a config whose tile cap is k_cap, for the plain compositor
    (with `pack_mean16` off: the anchor path keeps the f32 mean)."""
    num_tiles, kc = merge.ordered.shape
    dev = merge.ordered.device
    pos = merge.ordered.long()
    gidx = torch.where(pos >= 0, abins.sorted_gidx[torch.clamp(pos, min=0)],
                       0).reshape(-1)
    view = TileBins(
        sorted_gidx=gidx.to(torch.int32),
        sorted_slot=None,
        tile_start=(torch.arange(num_tiles, device=dev) * kc).to(torch.int32),
        tile_count=merge.k_used,
        num_pairs=abins.num_pairs,
        overflow=abins.overflow,
    )
    return view, config.replace(max_per_tile=kc, pack_mean16=False)


def composite_anchor_plain(fields: torch.Tensor, abins: AnchorBins,
                           width: int, height: int,
                           config: RenderConfig) -> Tuple[Composite, Merge]:
    """The plain version of kernel C: the merge, then the plain compositor
    over the ordered lists. `last_idx` indexes a tile's ordered list."""
    gx, gy = config.grid_size(width, height)
    merge = merge_tiles(abins, gx, gy, config)
    view, vcfg = ordered_view(abins, merge, config)
    return composite_image_plain(fields, view, width, height, vcfg), merge


def composite_anchor_backward_plain(
    fields: torch.Tensor,
    abins: AnchorBins,
    width: int,
    height: int,
    config: RenderConfig,
    composite: Composite,
    d_rgb: torch.Tensor,
    d_alpha: torch.Tensor,
) -> torch.Tensor:
    """The plain version of kernel D → pair gradient rows [4, M, 9]: the
    merge, the plain backward over the ordered lists, and each kept
    entry's row at (its row group, its sorted position). An entry meets
    each group at most once, so no row is written twice."""
    gx, gy = config.grid_size(width, height)
    merge = merge_tiles(abins, gx, gy, config)
    view, vcfg = ordered_view(abins, merge, config)
    rows = composite_backward_plain(fields, view, width, height, vcfg,
                                    composite, d_rgb, d_alpha)
    pos = merge.ordered.reshape(-1).long()
    keep = pos >= 0
    out = rows.new_zeros((4, abins.sorted_gidx.shape[0], GRAD_ROW))
    out[merge.group.reshape(-1)[keep].long(), pos[keep]] = rows[keep]
    return out


def fold_anchor_grads(dpairs: torch.Tensor, abins: AnchorBins, n: int,
                      config: RenderConfig | None = None) -> torch.Tensor:
    """Sum the four row groups [4, M, 9] in a fixed order and fold the
    entries onto the splats → [N, 9]: rows are copied to their slots (the
    slot map is a permutation), the anchors' slots are splats 0..N−1, and
    the dup tier's [max_dup, cap_b] slots are summed over max_dup and added
    at the compacted big splats (unique indices: deterministic). With
    `config.pack_grads` the summed rows are rounded to bf16 first, as JAX's
    anchor backward folds them (`anchor.py:1385-1397`)."""
    dsum = ((dpairs[0] + dpairs[1]) + dpairs[2]) + dpairs[3]
    if config is not None and config.pack_grads:
        dsum = quantize_bf16(dsum)
    slots = abins.sorted_slot.shape[0]
    cap_b = abins.idx_b.shape[0]
    buf = dsum.new_zeros((slots, GRAD_ROW))
    buf.index_copy_(0, abins.sorted_slot, dsum)
    dup = buf[n:].reshape((slots - n) // cap_b, cap_b, GRAD_ROW).sum(0)
    k = min(int(abins.n_big), cap_b)
    return buf[:n].index_add_(0, abins.idx_b[:k], dup[:k])
