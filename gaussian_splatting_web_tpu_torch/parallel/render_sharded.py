"""Tile-sharded forward rendering, the port of the JAX package's
`parallel/render_sharded.py`.

Pixel tiles are the unit of parallelism. Projection and binning run on
every rank, replicated; each rank composites only the tiles it owns
(`ops/rasterize.py::composite_tiles_auto`: kernel A's tile-list entry on
the card) and the image is put together with an all-gather over the mesh's
'tile' group. Tiles are dealt round-robin, as in the JAX package; where the
JAX package pads a rank's strip with repeats of real tiles, the port pads
with the empty sentinel tile gx·gy, whose slot composites nothing (a
repeated real tile would make kernel B store the same gradient rows from
two blocks).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..core.types import CameraParams, GaussianCloud
from ..ops.projection import project_gaussians
from ..ops.rasterize import assemble_image, composite_tiles_auto
from .mesh import AXES, Mesh


def _padded_tile_ids(num_tiles: int, n_shards: int,
                     chunk: int) -> Tuple[torch.Tensor, int]:
    """Tile ids padded so each shard gets an equal, chunk-aligned strip →
    (ids int32 [per · n_shards], per), the JAX function's ids: tiles are
    dealt round-robin (shard s gets ids s, s + n, s + 2n, ...) over
    arange(per · n_shards) % num_tiles, then re-flattened shard-major."""
    per = -(-num_tiles // n_shards)
    per = -(-per // chunk) * chunk
    total = per * n_shards
    ids = torch.arange(total, dtype=torch.int32) % num_tiles
    return ids.reshape(per, n_shards).T.reshape(-1), per


def shard_tile_ids(num_tiles: int, n_shards: int, chunk: int,
                   shard: int) -> torch.Tensor:
    """Shard `shard`'s strip of `_padded_tile_ids` with its padding (the
    dealt positions k · n_shards + shard ≥ num_tiles) replaced by the empty
    sentinel num_tiles → int32 [per]."""
    ids, per = _padded_tile_ids(num_tiles, n_shards, chunk)
    strip = ids[shard * per:(shard + 1) * per]
    dealt = torch.arange(per, dtype=torch.int32) * n_shards + shard
    return torch.where(dealt < num_tiles, strip, num_tiles)


def gather_tiles(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """All-gather each 'tile' rank's [per, ...] tiles → [n_tile · per, ...]
    in shard-major order (no autograd)."""
    n_tile = mesh.shape[AXES.tile]
    if mesh.tile_group is None:
        return local
    out = local.new_empty((n_tile * local.shape[0],) + local.shape[1:])
    # torch 2.13 renames all_gather_into_tensor to all_gather_single
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(out, local.contiguous(), group=mesh.tile_group)
    return out


def dealt_to_image(gathered: torch.Tensor, n_shards: int, width: int,
                   height: int, gx: int, gy: int) -> torch.Tensor:
    """Shard-major gathered tiles [n_shards · per, ts, ts, C] (slot [s, k]
    holds dealt position k · n_shards + s) → the image [H, W, C]."""
    ts, c = gathered.shape[1], gathered.shape[-1]
    per = gathered.shape[0] // n_shards
    row_major = gathered.reshape(n_shards, per, ts * ts, c).transpose(0, 1)
    return assemble_image(row_major.reshape(-1, ts * ts, c)[:gx * gy],
                          width, height, gx, gy)


def render_sharded(
    cloud: GaussianCloud,
    camera: CameraParams,
    width: int,
    height: int,
    mesh: Mesh,
    config: RenderConfig = RenderConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward render with tiles sharded over the mesh's 'tile' group →
    (rgb [H, W, 3] premultiplied, alpha [H, W]) on every rank, without the
    background (as the JAX function). Every rank of the tile group must
    call it with the same scene and camera."""
    gx, gy = config.grid_size(width, height)
    n_shards = mesh.shape[AXES.tile]
    mine = shard_tile_ids(gx * gy, n_shards, config.tile_chunk,
                          mesh.tile_index).to(cloud.device)
    with torch.no_grad():
        splats = project_gaussians(cloud, camera.to(cloud.device), width,
                                   height, config)
        local = composite_tiles_auto(splats, mine, width, height, config, gx)
        img = dealt_to_image(gather_tiles(local, mesh), n_shards, width,
                             height, gx, gy)
    return img[..., :3], img[..., 3]
