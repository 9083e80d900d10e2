"""Gaussian-sharded rendering and training, the port of the JAX package's
`parallel/gaussian_sharded.py`.

The gaussians (and, in training, their Adam moments) live sharded over the
mesh's 'tile' group: tile rank t holds rows [t·n_s, (t+1)·n_s) of the
model, N/S of its memory (`shard_model`, `init_sharded_train_state`). Each
rank projects only its own shard; the projected splats travel as packed
rows of 16 f32 (`_pack_splat_rows`) to the ranks that composite the tiles
they touch, through `ops/rasterize.py::composite_tiles_auto` (kernel A's
tile-list entry E-A on the card, B's E-B in the backward):

  * the ring (`render_gaussian_sharded`): every rank gathers all N rows
    (`ring_all_gather`) and composites its strided strip of tiles, the deal
    of `parallel/render_sharded.py`;
  * the banded paths (`render_gaussian_sharded_banded`): tile ownership is
    contiguous bands of tile rows, and a rank receives only the splats
    whose footprint rows meet its band, at most `cap_hop` from each shard
    (cut rows are counted in `overflow`). `stream="ring"`
    (`banded_candidates`) filters every shard's block per hop;
    `stream="a2a"` (`banded_candidates_a2a`, the default) classes each
    rank's own splats by destination band once and delivers them with one
    `all_to_all_single`.

The JAX package walks the rows around a `ppermute` ring and lets autodiff
transpose it. Here one all-gather (NCCL's all-gather is a ring already)
replaces the ring, and no collective runs inside autograd: the training
step composites from a detached leaf of the received rows, takes the
leaf's gradient, sends it back to the owners (a reduce-scatter over 'tile'
for the ring, the reverse all-to-all for a2a) and only then runs the
backward of each rank's own projection. Band lists are padded with the
empty sentinel tile gx·gy where the JAX package repeats real tiles (a
repeated real tile would have two blocks of kernel B store the same rows).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import (Callable, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..core.types import CameraParams, GaussianCloud
from ..models.gaussian_model import PARAMS, GaussianModel
from ..ops.projection import ProjectedSplats, project_gaussians
from ..ops.rasterize import assemble_image, composite_tiles_auto
from ..ops.sort import _footprints
from ..train.loss import full_f32, photometric_loss
from ..train.trainer import TrainState, make_optimizer
from .mesh import AXES, Mesh
from .render_sharded import dealt_to_image, gather_tiles, shard_tile_ids
from .train_sharded import _all_reduce_sum, local_batch, reduce_and_apply

ROW = 16            # packed row: 11 fields, the valid flag, 4 spare columns
VALID_COL = 11


def _pack_splat_rows(splats: ProjectedSplats) -> torch.Tensor:
    """ProjectedSplats → [n, 16] f32 rows: mean2d, conic, depth, radius,
    rgb, opacity, the valid flag (column 11) and four zero columns. Depth,
    radius and the flag only feed binning, so they carry no gradient."""
    n = splats.depth.shape[0]
    return torch.cat([
        splats.mean2d,
        splats.conic,
        splats.depth.detach()[:, None],
        splats.radius.detach()[:, None],
        splats.rgb,
        splats.opacity[:, None],
        splats.valid.to(torch.float32)[:, None],
        splats.mean2d.new_zeros((n, 4)),
    ], dim=1)


def _unpack_splat_rows(rows: torch.Tensor) -> ProjectedSplats:
    return ProjectedSplats(
        mean2d=rows[:, 0:2],
        conic=rows[:, 2:5],
        depth=rows[:, 5],
        radius=rows[:, 6],
        rgb=rows[:, 7:10],
        opacity=rows[:, 10],
        valid=rows[:, VALID_COL] > 0.5,
    )


def ring_all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every 'tile' rank's [n_s, ...] → [S·n_s, ...] in global shard order,
    the same on every rank of the group (JAX `ring_all_gather`, whose
    ppermute ring an all-gather computes); no autograd."""
    return gather_tiles(x, mesh)


def _reduce_scatter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[S·n_s, ...] on every 'tile' rank → this rank's block [n_s, ...] of
    the sum over the ranks (the transpose of `ring_all_gather`)."""
    if mesh.tile_group is None:
        return x
    s = mesh.shape[AXES.tile]
    out = x.new_empty((x.shape[0] // s,) + x.shape[1:])
    # torch 2.13 renames reduce_scatter_tensor to reduce_scatter_single
    scatter = getattr(dist, "reduce_scatter_single",
                      dist.reduce_scatter_tensor)
    scatter(out, x.contiguous(), op=dist.ReduceOp.SUM, group=mesh.tile_group)
    return out


def _all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Block b of [S·m, ...] goes to 'tile' rank b; the result holds the
    blocks received, in source order."""
    if mesh.tile_group is None:
        return x
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=mesh.tile_group)
    return out


def shard_model(model: Union[GaussianModel, GaussianCloud], mesh: Mesh):
    """This 'tile' rank's rows [t·n_s, (t+1)·n_s) of a GaussianModel (as a
    new GaussianModel) or a GaussianCloud. Raises ValueError when N is not
    a multiple of the 'tile' size (pad with dead gaussians first)."""
    s = mesh.shape[AXES.tile]
    n = model.num_gaussians
    if n % s:
        raise ValueError(f"N={n} not divisible by tile axis {s}")
    n_s = n // s
    rows = slice(mesh.tile_index * n_s, (mesh.tile_index + 1) * n_s)
    if isinstance(model, GaussianModel):
        return GaussianModel(*(getattr(model, f).detach()[rows]
                               for f in PARAMS)).to(model.device)
    return GaussianCloud(**{f.name: getattr(model, f.name)[rows]
                            for f in dataclasses.fields(model)})


def init_sharded_train_state(
    model: GaussianModel,
    mesh: Mesh,
    make_opt: Callable[[GaussianModel],
                       torch.optim.Optimizer] = make_optimizer,
) -> TrainState:
    """TrainState over this rank's shard of `model` with an optimizer
    `make_opt` builds over it, so parameters and Adam moments are N/S rows
    by construction (JAX `init_sharded_train_state`)."""
    shard = shard_model(model, mesh)
    return TrainState(shard, make_opt(shard))


# --- tile ownership ---------------------------------------------------------


def banded_tile_rows(gy: int, n_shards: int) -> int:
    """Tile rows per band (contiguous row-band tile ownership)."""
    return -(-gy // n_shards)


def banded_cap_hop(n: int, s: int, cand_factor: float) -> int:
    """Candidates a band takes from one shard: the expected n_s/s times
    `cand_factor`, at least 256, at most the shard size n_s."""
    n_s = n // s
    return min(n_s, max(int(cand_factor * n_s / s), 256))


def banded_band_tiles(width: int, height: int, s: int,
                      config: RenderConfig) -> Tuple[torch.Tensor, int, int]:
    """Contiguous row-band tile ownership → (band_tiles int32 [S·per_pad],
    per_band, per_pad): band b owns tiles [b·per_band, (b+1)·per_band) of
    the frame, listed in order and padded to a multiple of the tile chunk.
    Every padding slot, and every slot past the frame's last tile, holds
    the empty sentinel gx·gy (the JAX function repeats real tiles there)."""
    gx, gy = config.grid_size(width, height)
    num_tiles = gx * gy
    per_band = banded_tile_rows(gy, s) * gx
    chunk = min(config.tile_chunk, per_band)
    per_pad = -(-per_band // chunk) * chunk
    k = torch.arange(per_pad, dtype=torch.int32)
    tiles = torch.arange(s, dtype=torch.int32)[:, None] * per_band + k
    real = (k < per_band) & (tiles < num_tiles)
    return torch.where(real, tiles, num_tiles).reshape(-1), per_band, per_pad


def _band_image(gathered: torch.Tensor, s: int, per_band: int, width: int,
                height: int, gx: int, gy: int) -> torch.Tensor:
    """Band-major gathered tiles [S·per_pad, ts, ts, C] → the image: each
    band's real tiles are already in row-major order."""
    ts, c = gathered.shape[1], gathered.shape[-1]
    tiles = gathered.reshape(s, -1, ts * ts, c)[:, :per_band]
    return assemble_image(tiles.reshape(-1, ts * ts, c)[:gx * gy], width,
                          height, gx, gy)


def _full_image(local: torch.Tensor, mesh: Mesh, layout) -> torch.Tensor:
    """This rank's tiles `local` [L, ts, ts, 4] (with or without autograd)
    and the other 'tile' ranks' tiles (gathered, without) → the image
    [H, W, 4]. `layout(gathered, s)` puts rank-major tiles in place."""
    s = mesh.shape[AXES.tile]
    blocks = list(gather_tiles(local.detach(), mesh).reshape(
        (s,) + local.shape).unbind(0))
    blocks[mesh.tile_index] = local
    return layout(torch.cat(blocks), s)


# --- candidate selection ----------------------------------------------------


class Candidates(NamedTuple):
    """A rank's candidate rows [S·cap_hop, 16] (slot rows past a band's
    count are zero, valid 0), the overflow it counts, and what the way back
    needs: for the ring stream, per hop the source shard and the owned-row
    index of each kept candidate (−1 for an empty slot); for a2a, the
    owned-slot id (k·n_s + g) of each row sent (−1 for an empty one) and
    the slots per splat, `bmax`."""

    rows: torch.Tensor
    overflow: torch.Tensor
    back: torch.Tensor
    bmax: int = 0


def _band_span(splats: ProjectedSplats, width: int, height: int,
               config: RenderConfig):
    """(y0, y0 + rh, rh) of each splat's footprint rect in tile rows (the
    rect binning uses, so the band test drops no contributing splat)."""
    with torch.no_grad():
        _, y0, _, rh = _footprints(splats, width, height, config)
    return y0, y0 + rh, rh


def banded_candidates(splats_shard: ProjectedSplats, width: int, height: int,
                      mesh: Mesh, rows_per: int, cap_hop: int,
                      config: RenderConfig) -> Candidates:
    """`stream="ring"`: walk every shard's rows (one all-gather) in the JAX
    ring's order, hop k holding the block of shard (my − k) mod S, and keep
    per hop the live splats whose footprint rows meet this rank's band,
    compacted to `cap_hop` rows by a stable (class, position) sort. Each
    hop counts max(hits − cap_hop, 0) in the overflow."""
    s, my = mesh.shape[AXES.tile], mesh.tile_index
    packed = _pack_splat_rows(splats_shard).detach()
    n_s = packed.shape[0]
    y0, y1, _ = _band_span(splats_shard, width, height, config)
    prows = packed.clone()
    prows[:, 12] = y0.to(torch.float32)
    prows[:, 13] = y1.to(torch.float32)
    blocks = ring_all_gather(prows, mesh).reshape(s, n_s, ROW)
    band_lo, band_hi = float(my * rows_per), float((my + 1) * rows_per)
    slot = torch.arange(cap_hop, device=packed.device)
    cands, backs, over = [], [], packed.new_zeros((), dtype=torch.int64)
    for k in range(s):
        blk = blocks[(my - k) % s]
        hit = ((blk[:, 13] > band_lo) & (blk[:, 12] < band_hi)
               & (blk[:, VALID_COL] > 0.5))
        n_hit = hit.sum()
        # stable sort of the class: hits first, each class in row order
        idx = torch.sort((~hit).to(torch.uint8), stable=True).indices
        idx = idx[:cap_hop]
        ok = slot < n_hit
        cands.append(torch.where(ok[:, None], blk[idx], 0.0))
        backs.append(torch.where(ok, idx, -1))
        over = over + torch.clamp(n_hit - cap_hop, min=0)
    return Candidates(torch.cat(cands), over, torch.stack(backs))


def banded_candidates_a2a(splats_shard: ProjectedSplats, width: int,
                          height: int, mesh: Mesh, rows_per: int,
                          cap_hop: int, config: RenderConfig,
                          bmax: Optional[int] = None) -> Candidates:
    """`stream="a2a"`: each owned splat gets `bmax` destination slots
    (default min(S, 4)), slot k for band b0 + k of the bands b0..b1 its
    footprint rows touch; one stable sort by band gives each band's slots
    in slot order, the first `cap_hop` of each are sent, and one
    all-to-all delivers band b's rows to rank b. The overflow counts rows
    past `cap_hop` and bands past `bmax`."""
    s = mesh.shape[AXES.tile]
    if bmax is None:
        bmax = min(s, 4)
    packed = _pack_splat_rows(splats_shard).detach()
    n_s = packed.shape[0]
    dev = packed.device
    y0, y1, rh = _band_span(splats_shard, width, height, config)
    live = splats_shard.valid & (rh > 0)
    b0 = torch.clamp(y0 // rows_per, 0, s - 1)
    b1 = torch.clamp((y1 - 1) // rows_per, 0, s - 1)
    nb = torch.where(live, b1 - b0 + 1, 0)
    k = torch.arange(bmax, dtype=b0.dtype, device=dev)[:, None]
    dest = b0[None, :] + k                               # [bmax, n_s]
    cls = torch.where((k < nb[None, :]) & (dest < s), dest, s).reshape(-1)
    sorted_slot = torch.sort(cls, stable=True).indices   # [bmax·n_s]
    cnt = torch.bincount(cls.to(torch.int64), minlength=s + 1)[:s]
    start = torch.cumsum(cnt, 0) - cnt
    j = torch.arange(cap_hop, device=dev)
    idx = torch.clamp(start[:, None] + j, max=bmax * n_s - 1)  # [S, cap_hop]
    ok = j[None, :] < cnt[:, None]
    slots = sorted_slot[idx]
    send = torch.where(ok[..., None], packed[slots % n_s], 0.0)
    rows = _all_to_all(send.reshape(s * cap_hop, ROW), mesh)
    over = (torch.clamp(cnt - cap_hop, min=0).sum()
            + torch.clamp(nb - bmax, min=0).sum().to(torch.int64))
    return Candidates(rows, over, torch.where(ok, slots, -1), bmax)


def _return_ring(d_rows: torch.Tensor, back: torch.Tensor, n_s: int,
                 mesh: Mesh) -> torch.Tensor:
    """The ring stream's way back: each hop's candidate gradients are
    copied (kept rows are distinct, so nothing adds) into the block of the
    shard they came from, and a reduce-scatter sums each block over the
    'tile' ranks into its owner → [n_s, 16]."""
    s, my = mesh.shape[AXES.tile], mesh.tile_index
    cap_hop = back.shape[1]
    buf = d_rows.new_zeros((s, n_s, ROW))
    for k in range(s):
        keep = back[k] >= 0
        g = d_rows[k * cap_hop:(k + 1) * cap_hop][keep]
        buf[(my - k) % s].index_copy_(0, back[k][keep], g)
    return _reduce_scatter(buf.reshape(s * n_s, ROW), mesh)


def _return_a2a(d_rows: torch.Tensor, back: torch.Tensor, bmax: int,
                n_s: int, mesh: Mesh) -> torch.Tensor:
    """The a2a stream's way back: the reverse all-to-all returns each band's
    row gradients to the rank that sent the rows; they are copied into a
    zero [bmax·n_s, 16] buffer at their slot ids (unique: only rows that
    were sent, never the clipped indices past a band's count) and summed
    over the slot axis → [n_s, 16]. No atomics: the same bits every run."""
    d_send = _all_to_all(d_rows, mesh)
    keep = back.reshape(-1) >= 0
    buf = d_rows.new_zeros((bmax * n_s, ROW))
    buf.index_copy_(0, back.reshape(-1)[keep], d_send[keep])
    return buf.reshape(bmax, n_s, ROW).sum(0)


# --- rendering ---------------------------------------------------------------


def render_gaussian_sharded(
    cloud: GaussianCloud,
    camera: CameraParams,
    width: int,
    height: int,
    mesh: Mesh,
    config: RenderConfig = RenderConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward render with the gaussians sharded over 'tile': `cloud` is
    this rank's shard (`shard_model`). Each rank projects its shard, gathers
    every shard's rows and composites its strided strip of tiles. Returns
    (rgb [H, W, 3] premultiplied, alpha [H, W]) on every rank, without the
    background, as the JAX function."""
    gx, gy = config.grid_size(width, height)
    s = mesh.shape[AXES.tile]
    mine = shard_tile_ids(gx * gy, s, config.tile_chunk,
                          mesh.tile_index).to(cloud.device)
    with torch.no_grad():
        splats = project_gaussians(cloud, camera.to(cloud.device), width,
                                   height, config)
        rows = ring_all_gather(_pack_splat_rows(splats), mesh)
        local = composite_tiles_auto(_unpack_splat_rows(rows), mine, width,
                                     height, config, gx)
        img = dealt_to_image(gather_tiles(local, mesh), s, width, height,
                             gx, gy)
    return img[..., :3], img[..., 3]


def _select(stream: str):
    if stream not in ("a2a", "ring"):
        raise ValueError(f"stream must be 'a2a' or 'ring', got {stream!r}")
    return banded_candidates_a2a if stream == "a2a" else banded_candidates


def render_gaussian_sharded_banded(
    cloud: GaussianCloud,
    camera: CameraParams,
    width: int,
    height: int,
    mesh: Mesh,
    config: RenderConfig = RenderConfig(),
    cand_factor: float = 2.5,
    stream: str = "a2a",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gaussian-sharded forward render with banded binning: `cloud` is this
    rank's shard; each rank bins and composites only the ≈cand_factor·N/S
    candidates whose footprint rows meet its band of tile rows. Exact while
    the overflow is 0 (the band test uses binning's own rect). Returns
    (rgb, alpha, overflow) on every rank, the overflow summed over 'tile'."""
    gx, gy = config.grid_size(width, height)
    s = mesh.shape[AXES.tile]
    rows_per = banded_tile_rows(gy, s)
    band_tiles, per_band, per_pad = banded_band_tiles(width, height, s,
                                                      config)
    mine = band_tiles[mesh.tile_index * per_pad:
                      (mesh.tile_index + 1) * per_pad].to(cloud.device)
    cap_hop = banded_cap_hop(cloud.num_gaussians * s, s, cand_factor)
    with torch.no_grad():
        splats = project_gaussians(cloud, camera.to(cloud.device), width,
                                   height, config)
        cand = _select(stream)(splats, width, height, mesh, rows_per,
                               cap_hop, config)
        local = composite_tiles_auto(_unpack_splat_rows(cand.rows), mine,
                                     width, height, config, gx)
        img = _band_image(gather_tiles(local, mesh), s, per_band, width,
                          height, gx, gy)
        overflow = _all_reduce_sum(cand.overflow, mesh.tile_group)
    return img[..., :3], img[..., 3], overflow


# --- training ----------------------------------------------------------------


def make_gaussian_sharded_train_step(
    width: int,
    height: int,
    mesh: Mesh,
    config: RenderConfig = RenderConfig(),
    lambda_dssim: float = 0.2,
    active_sh_degree: Optional[int] = None,
    banded: bool = False,
    cand_factor: float = 2.5,
    stream: str = "a2a",
) -> Callable[[TrainState, Sequence[CameraParams], torch.Tensor],
              Tuple[TrainState, torch.Tensor, dict]]:
    """Build a (state, cameras, targets [B, H, W, 3]) → (state, loss,
    {"overflow"}) step over sharded parameters: `state` holds this rank's
    shard (`init_sharded_train_state`), so its Adam moments are N/S rows;
    `cameras` is the whole batch of B cameras, split over 'data' as
    `make_sharded_train_step` splits it. `banded` selects the banded
    candidates (`stream`, `cand_factor` as in the banded render; N is S
    times the shard's rows) over the ring.

    Per camera a rank projects its shard, receives its candidate rows as a
    detached leaf, composites its own tiles from it with autograd and takes
    the other ranks' tiles without. The backward of the unscaled loss stops
    at the leaves; their gradients go back to the owners (reduce-scatter
    for the ring and the ring stream, the reverse all-to-all for a2a), and
    each rank's projection backward runs from there. The shard gradients
    are then averaged over 'data': the JAX package's gradients, the sum
    over the tile ranks of each rank's own tiles. The loss is JAX's number,
    the mean over the data ranks of the sum over the tile ranks of
    loss / n_tile; aux["overflow"] sums the candidate overflow over the
    local cameras, 'tile' and 'data'. Turns TF32 off (`loss.full_f32`)."""
    full_f32()
    gx, gy = config.grid_size(width, height)
    n_tile = mesh.shape[AXES.tile]
    if banded:
        select = _select(stream)
        rows_per = banded_tile_rows(gy, n_tile)
        band_tiles, per_band, per = banded_band_tiles(width, height, n_tile,
                                                      config)
        mine = band_tiles[mesh.tile_index * per:(mesh.tile_index + 1) * per]

        def layout(tiles, s):
            return _band_image(tiles, s, per_band, width, height, gx, gy)
    else:
        mine = shard_tile_ids(gx * gy, n_tile, config.tile_chunk,
                              mesh.tile_index)

        def layout(tiles, s):
            return dealt_to_image(tiles, s, width, height, gx, gy)
    bg = torch.tensor(config.background, dtype=torch.float32)

    def step(state: TrainState, cameras: Sequence[CameraParams],
             targets: torch.Tensor):
        cameras, targets = local_batch(cameras, targets, mesh)
        dev = state.model.device
        n_s = state.model.num_gaussians
        state.optimizer.zero_grad(set_to_none=True)
        cloud = state.model.to_cloud(active_sh_degree)
        owned: List[torch.Tensor] = []   # each camera's own rows (autograd)
        leaves = []                      # (leaf, its gradient → owned rows)
        total = 0.0
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        for camera, target in zip(cameras, targets):
            splats = project_gaussians(cloud, camera.to(dev), width, height,
                                       config)
            owned.append(_pack_splat_rows(splats))
            if not banded:
                rows = ring_all_gather(owned[-1].detach(), mesh)
                back = partial(_reduce_scatter, mesh=mesh)
            else:
                cand = select(splats, width, height, mesh, rows_per,
                              banded_cap_hop(n_s * n_tile, n_tile,
                                             cand_factor), config)
                rows, overflow = cand.rows, overflow + cand.overflow
                back = (partial(_return_a2a, back=cand.back, bmax=cand.bmax,
                                n_s=n_s, mesh=mesh) if stream == "a2a"
                        else partial(_return_ring, back=cand.back, n_s=n_s,
                                     mesh=mesh))
            leaf = rows.detach().requires_grad_(True)
            leaves.append((leaf, back))
            local = composite_tiles_auto(_unpack_splat_rows(leaf),
                                         mine.to(dev), width, height, config,
                                         gx)
            out = _full_image(local, mesh, layout)
            img = out[..., :3] + (1.0 - out[..., 3:4]) * bg.to(dev)
            total = total + photometric_loss(img, target.to(dev),
                                             lambda_dssim)
        loss = total / len(cameras)
        loss.backward()
        # the leaves' gradients back to the owners, then each rank's own
        # projection backward
        torch.autograd.backward(owned, [
            back(leaf.grad if leaf.grad is not None
                 else torch.zeros_like(leaf))
            for leaf, back in leaves])

        reported = reduce_and_apply(state, loss, mesh, tile_sum=False)
        _all_reduce_sum(overflow, mesh.tile_group)
        _all_reduce_sum(overflow, mesh.data_group)
        return state, reported, {"overflow": overflow}

    return step
