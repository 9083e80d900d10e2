"""Adaptive density control (INRIA §5.2: clone / split / prune / opacity
reset) in a fixed-capacity arena, the port of the JAX package's
`train/densify.py`.

The model holds `capacity` slots and an `alive` mask marks real gaussians
(dead slots sit at opacity logit −100 and never rasterize). Clone and
split place children into free slots by prefix allocation (the k-th
wanting source gets the k-th free slot), so shapes never change and the
optimizer keeps its parameters; overflow defers growth to the next round.
Unlike the JAX package, which returns new arrays, the round writes the
model's parameters in place (under no_grad), so the optimizer's moments
stay attached to the same tensors.

Densification pressure is the accumulated norm of the loss gradient with
respect to the screen-space splat centres (train_loop's `vs_aux`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.gaussian_model import PARAMS, GaussianModel
from ..ops.projection import quat_to_rotmat
from ..utils import tracing

DEAD_OPACITY = -100.0  # sigmoid ≈ 0: dead slots never rasterize


@dataclasses.dataclass
class DensifyState:
    grad_accum: torch.Tensor   # [C] accumulated ||d loss / d mean2d||
    denom: torch.Tensor        # [C] number of accumulations
    alive: torch.Tensor        # [C] bool
    # [C] max projected pixel radius since the last round (INRIA's
    # max_radii2D, for the screen-size prune); None = not tracked
    max_radius2d: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]


def pad_to_capacity(model: GaussianModel, capacity: int
                    ) -> Tuple[GaussianModel, DensifyState]:
    """Place a model into a fixed-capacity arena (a new model; dead rows
    are zero with opacity logit DEAD_OPACITY)."""
    n = model.num_gaussians
    if capacity < n:
        raise ValueError(f"capacity {capacity} < model size {n}")
    dev = model.device

    def padf(x, fill=0.0):
        tail = torch.full((capacity - n,) + tuple(x.shape[1:]), fill,
                          dtype=x.dtype, device=dev)
        return torch.cat([x.detach(), tail])

    padded = GaussianModel(
        padf(model.xyz), padf(model.log_scale), padf(model.quat),
        padf(model.opacity_logit, DEAD_OPACITY), padf(model.sh_dc),
        padf(model.sh_rest)).to(dev)
    alive = torch.arange(capacity, device=dev) < n
    zeros = torch.zeros((capacity,), dtype=torch.float32, device=dev)
    return padded, DensifyState(grad_accum=zeros, denom=zeros.clone(),
                                alive=alive, max_radius2d=zeros.clone())


@tracing.spanned("densify_stats")
def accumulate_stats(state: DensifyState, d_mean2d: torch.Tensor,
                     visible: torch.Tensor,
                     radius2d: Optional[torch.Tensor] = None
                     ) -> DensifyState:
    """Add this step's screen-space positional gradient norms for visible
    splats (INRIA add_densification_stats) and max-accumulate the
    projected pixel radius (INRIA's max_radii2D)."""
    norm = torch.linalg.vector_norm(d_mean2d, dim=-1)
    vis = visible & state.alive
    mr = state.max_radius2d
    if mr is not None and radius2d is not None:
        mr = torch.maximum(mr, torch.where(vis, radius2d, 0.0))
    return DensifyState(
        grad_accum=state.grad_accum + torch.where(vis, norm, 0.0),
        denom=state.denom + vis.to(torch.float32),
        alive=state.alive,
        max_radius2d=mr,
    )


def _prefix(mask: torch.Tensor) -> torch.Tensor:
    """Indices of the set entries, ascending, padded with 0 to len(mask)."""
    idx = torch.nonzero(mask).squeeze(1)
    out = torch.zeros_like(mask, dtype=torch.int64)
    out[:idx.shape[0]] = idx
    return out


def _alloc(free_ok: torch.Tensor, want: torch.Tensor):
    """Map the k-th wanting source to the k-th free slot. Returns
    (src_idx [C], dst_idx [C], pair_live [C])."""
    c = free_ok.shape[0]
    n_pairs = torch.minimum(free_ok.sum(), want.sum())
    live = torch.arange(c, device=free_ok.device) < n_pairs
    return _prefix(want), _prefix(free_ok), live


def _placed(idx: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    mask = torch.zeros_like(live)
    mask[idx[live]] = True
    return mask


@torch.no_grad()
def densify_and_prune(
    model: GaussianModel,
    state: DensifyState,
    generator: Optional[torch.Generator] = None,
    grad_threshold: float = 2e-4,
    percent_dense: float = 0.01,
    scene_extent: float = 1.0,
    min_opacity: float = 0.005,
    max_world_radius_frac: Optional[float] = None,
    max_screen_size: Optional[float] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[GaussianModel, DensifyState, torch.Tensor]:
    """One INRIA densification round on the arena, written into `model`.

    Clone: an exact copy into a free slot. Split: two children, both
    resampled from the source with N(0, 1) offsets in its rotated scale
    frame and scale ÷ 1.6, and the source pruned only if both children
    were placed. Then prune by opacity, optionally by world size
    (`max_world_radius_frac` · extent) and by screen size
    (`max_screen_size` px since the last round).

    The split offsets are `noise` = (first children, second children),
    two [C, 3] arrays, when given (a test hands over the JAX draws);
    otherwise they are drawn from `generator` on the CPU.

    Returns (model, state, changed): `changed` marks the slots written or
    freed this round, the rows whose Adam moments the caller zeroes
    (train_loop.reset_opt_rows)."""
    c = state.capacity
    dev = model.device
    if noise is None:
        noise = [torch.randn((c, 3), generator=generator) for _ in range(2)]
    noise = [z.to(dev, torch.float32) if isinstance(z, torch.Tensor)
             else torch.tensor(np.asarray(z), dtype=torch.float32, device=dev)
             for z in noise]
    params = {f: getattr(model, f).detach() for f in PARAMS}

    avg_grad = state.grad_accum / torch.clamp(state.denom, min=1.0)
    max_scale = torch.exp(params["log_scale"].amax(dim=-1))
    dense_limit = percent_dense * scene_extent
    hot = state.alive & (avg_grad >= grad_threshold)
    clone_mask = hot & (max_scale <= dense_limit)
    split_mask = hot & (max_scale > dense_limit)
    log_16 = torch.log(torch.tensor(1.6, dtype=torch.float32, device=dev))

    def children(src, z):
        child = {f: p[src] for f, p in params.items()}
        is_split = split_mask[src][:, None]
        rot = quat_to_rotmat(child["quat"])
        offset = torch.einsum("nij,nj->ni", rot,
                              z * torch.exp(child["log_scale"]))
        child["xyz"] = torch.where(is_split, child["xyz"] + offset,
                                   child["xyz"])
        child["log_scale"] = torch.where(
            is_split, child["log_scale"] - log_16, child["log_scale"])
        return child

    free = ~state.alive
    # pass 1: one child per hot source (clone copy or split child #1)
    src1, dst1, live1 = _alloc(free, clone_mask | split_mask)
    child1 = children(src1, noise[0])
    # pass 2: split child #2, from the free slots pass 1 did not take
    taken1 = _placed(dst1, live1)
    src2, dst2, live2 = _alloc(free & ~taken1, split_mask)
    child2 = children(src2, noise[1])

    new = {f: p.clone() for f, p in params.items()}
    for f in PARAMS:
        new[f][dst1[live1]] = child1[f][live1]
        new[f][dst2[live2]] = child2[f][live2]
    taken2 = _placed(dst2, live2)
    alive = state.alive | taken1 | taken2
    changed = taken1 | taken2

    # prune split sources whose children were both placed
    fully_split = split_mask & _placed(src1, live1) & _placed(src2, live2)
    alive = alive & ~fully_split
    changed = changed | fully_split

    dead = torch.sigmoid(new["opacity_logit"]) < min_opacity
    if max_world_radius_frac is not None:
        dead = dead | (torch.exp(new["log_scale"].amax(dim=-1))
                       > max_world_radius_frac * scene_extent)
    if max_screen_size is not None and state.max_radius2d is not None:
        dead = dead | (state.max_radius2d > max_screen_size)
    changed = changed | (alive & dead)
    alive = alive & ~dead
    new["opacity_logit"] = torch.where(alive, new["opacity_logit"],
                                       DEAD_OPACITY)

    for f in PARAMS:
        getattr(model, f).copy_(new[f])
    zeros = torch.zeros((c,), dtype=torch.float32, device=dev)
    return model, DensifyState(
        grad_accum=zeros, denom=zeros.clone(), alive=alive,
        max_radius2d=None if state.max_radius2d is None else zeros.clone(),
    ), changed


@torch.no_grad()
def reset_opacity(model: GaussianModel, alive: torch.Tensor,
                  max_opacity: float = 0.01) -> GaussianModel:
    """INRIA periodic opacity reset: clamp opacity to ≤ max_opacity, in
    place; dead slots stay at DEAD_OPACITY."""
    cap = torch.log(torch.tensor(max_opacity / (1 - max_opacity),
                                 dtype=torch.float32, device=model.device))
    logit = model.opacity_logit
    logit.copy_(torch.where(alive, torch.minimum(logit, cap), DEAD_OPACITY))
    return model


def compact(model: GaussianModel, state: DensifyState) -> GaussianModel:
    """The alive slots only, as a new model (for export)."""
    alive = state.alive.to(model.device)
    return GaussianModel(*(getattr(model, f).detach()[alive]
                           for f in PARAMS)).to(model.device)
