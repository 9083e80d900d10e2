"""The ('data', 'tile') layout of a process group, the port of the JAX
package's `parallel/mesh.py`.

'data' shards the camera batch (data parallelism over views) and 'tile'
shards the image tiles of a view. The JAX package lays devices out in a
`jax.sharding.Mesh`; here the unit is a rank of a `torch.distributed`
process group (gloo on the CPU, NCCL on the card), with the same layout:
group rank r sits at d = r // tile, t = r % tile, 'tile' the minor axis.
`make_mesh` builds one sub-group per row (the ranks that share the tiles of
a view) and per column (the ranks that hold the same tiles of different
views). Without an initialised process group the mesh is 1 × 1, this
process alone, and has no sub-groups.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    tile: str = "tile"


AXES = MeshAxes()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a ('data', 'tile') mesh: `shape` as the JAX
    mesh's ({"data": n_data, "tile": n_tile}), its coordinates, and the
    sub-groups it belongs to: `tile_group` (its row: the n_tile ranks that
    composite the tiles of one view, in tile order) and `data_group` (its
    column: the n_data ranks at its tile index). Both are None on the 1 × 1
    mesh of a process without a process group."""

    shape: Dict[str, int]
    data_index: int = 0
    tile_index: int = 0
    tile_group: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None


def mesh_shape(n: int, data: Optional[int] = None,
               tile: Optional[int] = None) -> Tuple[int, int]:
    """(data, tile) for n ranks, by the JAX `make_mesh`'s rule: with neither
    given, every rank goes to 'tile'; with one given, the other takes the
    rest. Raises ValueError when data · tile != n."""
    if data is None and tile is None:
        data, tile = 1, n
    elif data is None:
        data = n // tile
    elif tile is None:
        tile = n // data
    if data * tile != n:
        raise ValueError(f"mesh {data}x{tile} != {n} devices")
    return data, tile


def make_mesh(data: Optional[int] = None, tile: Optional[int] = None,
              group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """Lay the ranks of `group` (default: the whole initialised process
    group) out as a ('data', 'tile') mesh. Every rank of the default group
    must call it, in the same order as its other group calls
    (`dist.new_group`'s rule)."""
    if not (dist.is_available() and dist.is_initialized()):
        if group is not None:
            raise ValueError("a group was given, but no process group is "
                             "initialised")
        data, tile = mesh_shape(1, data, tile)
        return Mesh(shape={AXES.data: data, AXES.tile: tile})
    group = group or dist.group.WORLD
    ranks = dist.get_process_group_ranks(group)
    data, tile = mesh_shape(len(ranks), data, tile)
    me = dist.get_rank(group)
    rows = [dist.new_group([ranks[d * tile + t] for t in range(tile)])
            for d in range(data)]
    cols = [dist.new_group([ranks[d * tile + t] for d in range(data)])
            for t in range(tile)]
    shape = {AXES.data: data, AXES.tile: tile}
    if me < 0:                  # not in `group`: no place in the mesh
        return Mesh(shape=shape)
    d, t = divmod(me, tile)
    return Mesh(shape=shape, data_index=d, tile_index=t, tile_group=rows[d],
                data_group=cols[t])
