"""Multi-device rendering and training of the port over `torch.distributed`
(the JAX package's `parallel/`): tile sharding with replicated parameters
(`render_sharded`, `make_sharded_train_step`), Gaussian sharding with the
parameters and Adam moments at N/S a rank (`gaussian_sharded`), and the
multi-host start and the checkpoint-restart loop (`multihost`)."""

from .gaussian_sharded import (
    banded_band_tiles,
    banded_candidates,
    banded_candidates_a2a,
    banded_cap_hop,
    banded_tile_rows,
    init_sharded_train_state,
    make_gaussian_sharded_train_step,
    render_gaussian_sharded,
    render_gaussian_sharded_banded,
    ring_all_gather,
    shard_model,
)
from .mesh import MeshAxes, make_mesh
from .multihost import initialize_multihost, run_with_restarts
from .render_sharded import render_sharded
from .train_sharded import make_sharded_train_step

__all__ = [
    "MeshAxes",
    "banded_band_tiles",
    "banded_candidates",
    "banded_candidates_a2a",
    "banded_cap_hop",
    "banded_tile_rows",
    "init_sharded_train_state",
    "initialize_multihost",
    "make_gaussian_sharded_train_step",
    "make_mesh",
    "make_sharded_train_step",
    "render_gaussian_sharded",
    "render_gaussian_sharded_banded",
    "render_sharded",
    "ring_all_gather",
    "run_with_restarts",
    "shard_model",
]
