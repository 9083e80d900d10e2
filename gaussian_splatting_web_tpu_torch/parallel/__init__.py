"""Multi-device rendering and training of the port over `torch.distributed`
(the JAX package's `parallel/`): tile sharding with replicated parameters.
Gaussian sharding and multi-host restarts are not ported yet (ROADMAP §1
items 10b and 10c)."""

from .mesh import MeshAxes, make_mesh
from .render_sharded import render_sharded
from .train_sharded import make_sharded_train_step

__all__ = [
    "MeshAxes",
    "make_mesh",
    "make_sharded_train_step",
    "render_sharded",
]
