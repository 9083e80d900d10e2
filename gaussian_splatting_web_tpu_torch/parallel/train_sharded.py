"""Multi-device training step: camera-batch data parallelism × pixel-tile
sharding, the port of the JAX package's `parallel/train_sharded.py`.

Every rank holds the whole model and receives the whole camera batch:

  * data rank d takes the contiguous block [d·B/n_data, (d+1)·B/n_data) of
    the batch (what `P('data')` gives a JAX device);
  * per camera, tile rank t composites its strided strip of tiles
    (`composite_tiles_auto`: kernels A's and B's tile-list entries on the
    card), gathers the other ranks' tiles over the 'tile' group and forms
    the full image, which SSIM's windows need;
  * the loss is the mean over the local cameras of L1 + D-SSIM of the full
    image, and gradients are summed over 'tile' and averaged over 'data'.

The JAX package gathers the tiles inside autodiff, with the loss scaled by
1/n_tile so that the gather's transpose (a psum-scatter of cotangents)
gives each rank its own tiles' cotangent. Here the other ranks' tiles
enter the image without autograd and this rank's own tiles with it, so the
backward gives each rank the gradient through its own tiles of the
unscaled loss; one all-reduce of the parameter gradients (sum over
'tile', then mean over 'data') gives the same gradients, with no
collective inside autograd. Parameters stay identical on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..core.types import CameraParams
from ..ops.projection import project_gaussians
from ..ops.rasterize import composite_tiles_auto
from ..train.loss import full_f32, photometric_loss
from ..train.trainer import TrainState, apply_gradients
from .mesh import AXES, Mesh
from .render_sharded import dealt_to_image, gather_tiles, shard_tile_ids


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def local_batch(cameras: Sequence[CameraParams], targets: torch.Tensor,
                mesh: Mesh):
    """This data rank's contiguous block of the camera batch and its targets
    (what `P('data')` gives a JAX device); B must split over 'data'."""
    n_data = mesh.shape[AXES.data]
    if len(cameras) % n_data:
        raise ValueError(f"a batch of {len(cameras)} cameras does not split "
                         f"over {n_data} data ranks")
    b = len(cameras) // n_data
    lo = mesh.data_index * b
    return cameras[lo:lo + b], targets[lo:lo + b]


def reduce_and_apply(state: TrainState, loss: torch.Tensor, mesh: Mesh,
                     tile_sum: bool) -> torch.Tensor:
    """The end of a sharded step on every rank: the parameter gradients in
    .grad are summed over 'tile' (when `tile_sum`; a Gaussian-sharded
    step's shard gradients already hold every tile's part) and averaged
    over 'data', one flat all-reduce each (no copy when neither reduces
    over more than one rank: a Gaussian-sharded step on a 1 x S mesh);
    Adam takes one step. Returns JAX's reported loss: the mean over the
    data ranks of the sum over the tile ranks of loss / n_tile."""
    n_tile = mesh.shape[AXES.tile]
    n_data = mesh.shape[AXES.data]
    params = list(state.model.parameters())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    if (tile_sum and n_tile > 1) or n_data > 1:
        flat = torch.cat([g.reshape(-1) for g in grads])
        if tile_sum:
            _all_reduce_sum(flat, mesh.tile_group)
        _all_reduce_sum(flat, mesh.data_group)
        flat /= n_data
        for p, g in zip(params, flat.split([q.numel() for q in params])):
            p.grad = g.view_as(p).clone()
    else:
        for p, g in zip(params, grads):
            p.grad = g
    apply_gradients(state)

    reported = (loss.detach() / n_tile).reshape(1)
    _all_reduce_sum(reported, mesh.tile_group)
    _all_reduce_sum(reported, mesh.data_group)
    return reported[0] / n_data


def make_sharded_train_step(
    width: int,
    height: int,
    mesh: Mesh,
    config: RenderConfig = RenderConfig(),
    lambda_dssim: float = 0.2,
    active_sh_degree: Optional[int] = None,
) -> Callable[[TrainState, Sequence[CameraParams], torch.Tensor],
              Tuple[TrainState, torch.Tensor]]:
    """Build a (state, cameras, targets [B, H, W, 3]) → (state, loss) step
    on the model's device; `cameras` is the whole batch of B cameras (B
    divisible by the mesh's 'data' size). Every rank of the mesh calls it.
    The loss is JAX's number: the mean over the data ranks of the sum over
    the tile ranks of loss / n_tile. The reduced gradients stay in the
    parameters' .grad. Turns TF32 off (`loss.full_f32`)."""
    full_f32()
    gx, gy = config.grid_size(width, height)
    n_tile = mesh.shape[AXES.tile]
    ts = config.tile_size
    mine = shard_tile_ids(gx * gy, n_tile, config.tile_chunk,
                          mesh.tile_index)
    bg = torch.tensor(config.background, dtype=torch.float32)

    def image(cloud, camera):
        splats = project_gaussians(cloud, camera, width, height, config)
        local = composite_tiles_auto(splats, mine.to(cloud.device), width,
                                     height, config, gx)
        tiles = list(gather_tiles(local.detach(), mesh).reshape(
            n_tile, -1, ts, ts, 4).unbind(0))
        tiles[mesh.tile_index] = local
        out = dealt_to_image(torch.cat(tiles), n_tile, width, height, gx, gy)
        return out[..., :3] + (1.0 - out[..., 3:4]) * bg.to(out.device)

    def step(state: TrainState, cameras: Sequence[CameraParams],
             targets: torch.Tensor):
        cameras, targets = local_batch(cameras, targets, mesh)
        dev = state.model.device
        state.optimizer.zero_grad(set_to_none=True)
        cloud = state.model.to_cloud(active_sh_degree)
        total = 0.0
        for camera, target in zip(cameras, targets):
            img = image(cloud, camera.to(dev))
            total = total + photometric_loss(img, target.to(dev),
                                             lambda_dssim)
        loss = total / len(cameras)
        loss.backward()
        return state, reduce_and_apply(state, loss, mesh, tile_sum=True)

    return step
