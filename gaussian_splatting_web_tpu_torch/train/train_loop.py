"""Full 3DGS training loop, the port of the JAX package's
`train/train_loop.py`: photometric optimisation, adaptive density control
and progressive SH against posed images (io.dataset).

  * one step computes the loss, the parameter gradients AND the
    screen-space positional gradients that drive densification, the latter
    through a zero auxiliary tensor added to the projected means (its
    gradient is d loss / d mean2d), scaled to INRIA's half-viewport units;
  * every `densify_every` steps a fixed-shape arena round (train.densify)
    clones, splits and prunes; the Adam moments of exactly the rows the
    round wrote or freed are zeroed (`reset_opt_rows`), survivors keep
    theirs;
  * opacity reset every `opacity_reset_every` steps, and one more SH band
    every `sh_upgrade_every` steps.

`train` runs on the card (`device="cuda"`, the default) and raises when
there is none; the CPU runs only when asked for.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..core.types import CameraParams
from ..io.dataset import View, scene_extent
from ..models.gaussian_model import PARAMS, GaussianModel
from ..ops.projection import project_gaussians
from ..ops.rasterize import bin_and_composite
from ..utils import tracing
from .densify import (
    DensifyState,
    accumulate_stats,
    densify_and_prune,
    pad_to_capacity,
    reset_opacity,
)
from .loss import full_f32, photometric_loss
from .trainer import TrainState, apply_gradients, make_optimizer


def resolve_device(device) -> torch.device:
    """The torch device to train on; a CUDA device that is not there is an
    error, never a switch to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           "(pass device='cpu' to train on the CPU)")
    return dev


@torch.no_grad()
def reset_opt_rows(optimizer: torch.optim.Optimizer,
                   changed: torch.Tensor) -> None:
    """Zero the Adam moments (exp_avg, exp_avg_sq) at `changed` rows of
    every per-gaussian parameter: INRIA zeroes the state of new rows
    (cat_tensors_to_optimizer) and drops pruned rows' state; in the arena
    both become "zero the rows the round touched". The step counts stay."""
    c = changed.shape[0]
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            for key in ("exp_avg", "exp_avg_sq"):
                m = st.get(key)
                if m is not None and m.dim() >= 1 and m.shape[0] == c:
                    m[changed.to(m.device)] = 0.0


@torch.no_grad()
def reset_opt_opacity(optimizer: torch.optim.Optimizer,
                      opacity_logit: torch.Tensor) -> None:
    """Zero the opacity moments of every row (INRIA reset_opacity replaces
    the opacity tensor in the optimizer with fresh state)."""
    st = optimizer.state.get(opacity_logit, {})
    for key in ("exp_avg", "exp_avg_sq"):
        if key in st:
            st[key].zero_()


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    iterations: int = 7000
    densify_from: int = 500
    densify_until: int = 5000
    densify_every: int = 300
    opacity_reset_every: int = 3000
    sh_upgrade_every: int = 1000
    grad_threshold: float = 2e-4
    percent_dense: float = 0.01
    min_opacity: float = 0.005
    # INRIA's world-size prune (scales.max > frac · extent) past
    # world_prune_from; None disables
    world_radius_frac: Optional[float] = 0.1
    world_prune_from: int = 3000
    # INRIA's screen-size prune (projected radius > 20 px since the last
    # round) past world_prune_from; None disables
    screen_size_px: Optional[float] = 20.0
    lambda_dssim: float = 0.2
    capacity_factor: float = 4.0   # arena size as a multiple of initial N
    log_every: int = 50
    seed: int = 0
    steps_per_call: int = 25       # kept for the 1:1 conversion with the
                                   # JAX config; ignored (a TPU dispatch
                                   # batching, ROADMAP §1)


def make_densify_train_step(width: int, height: int, config: RenderConfig,
                            lambda_dssim: float):
    """(state, dstate, camera, target, sh_degree) → (state, dstate, loss).
    Turns TF32 off (`loss.full_f32`)."""
    full_f32()

    @tracing.spanned("step")
    def step(state: TrainState, dstate: DensifyState, camera: CameraParams,
             target: torch.Tensor, sh_degree: int):
        model = state.model
        dev = model.device
        state.optimizer.zero_grad(set_to_none=True)
        # the step's own differentiable work goes into the spans of its
        # layers, so every backward node maps to one
        with tracing.span("projection"):
            cloud = model.to_cloud(sh_degree)
        splats = project_gaussians(cloud, camera.to(dev), width, height,
                                   config)
        with tracing.span("projection"):
            vs_aux = torch.zeros((model.num_gaussians, 2),
                                 dtype=torch.float32, device=dev,
                                 requires_grad=True)
            splats = dataclasses.replace(splats,
                                         mean2d=splats.mean2d + vs_aux)
        out, _ = bin_and_composite(splats, width, height, config)
        with tracing.span("composite"):
            bg = torch.tensor(config.background, dtype=out.rgb.dtype,
                              device=dev)
            img = out.rgb + (1.0 - out.alpha[..., None]) * bg
        loss = photometric_loss(img, target, lambda_dssim)
        with tracing.span("backward"):
            loss.backward()
        apply_gradients(state)
        # densification pressure in INRIA's units: their backward emits
        # view-space gradients scaled by (W/2, H/2) (diff-gaussian-
        # rasterization backward.cu), which grad_threshold=2e-4 assumes;
        # mean2d here is in pixels
        half_viewport = vs_aux.new_tensor([width * 0.5, height * 0.5])
        dstate = accumulate_stats(dstate, vs_aux.grad * half_viewport,
                                  splats.valid,
                                  radius2d=splats.radius.detach())
        return state, dstate, loss.detach()

    return step


def _refuse_on_sharded_arena(loop: TrainLoopConfig,
                             checkpoint_dir: Optional[str]) -> None:
    """What a Gaussian-sharded arena cannot do yet raises here, before the
    first step, rather than doing the wrong thing: a densification round
    (it clones, splits and prunes rows of one rank's shard, and the load
    between ranks would need rebalancing), an opacity reset (its moments
    reset is per shard) and the loop state's checkpoint (it would have to
    be written and read per shard)."""
    why = " is not implemented on a Gaussian-sharded arena"
    if checkpoint_dir:
        raise NotImplementedError(
            "a checkpoint of the loop state" + why + ": each rank holds only "
            "its shard of the model, its Adam moments and its DensifyState, "
            "and per-shard checkpoints are not written yet")
    its = range(1, loop.iterations + 1)
    if any(loop.densify_from <= it <= loop.densify_until
           and it % loop.densify_every == 0 for it in its):
        raise NotImplementedError(
            "a densification round" + why + ": clones, splits and prunes "
            "would change each shard's rows, and the load between ranks "
            "needs rebalancing (set densify_from past the last iteration)")
    if any(it % loop.opacity_reset_every == 0 for it in its):
        raise NotImplementedError(
            "an opacity reset" + why + " (set opacity_reset_every past the "
            "last iteration)")


def _raise_on_overflow(step_fn, it: int) -> None:
    """A band of the Gaussian-sharded exchange takes at most `cand_factor`
    times its even share of one shard's rows; the rows past that are left
    out of the frame and get no gradient. `step_fn.overflow` counts them
    on the device, summed over the ranks and the steps, so every rank
    reads the same count and raises together."""
    cut = int(step_fn.overflow)
    if cut:
        raise RuntimeError(
            f"the Gaussian-sharded exchange cut {cut} candidate rows by "
            f"iteration {it}: they were left out of their frames and got no "
            "gradient. A band took more than its share of one rank's rows; "
            "give every rank at least one row of tiles (a taller frame) or "
            "shard over fewer ranks")


def _sharded_arena(model, mesh, dev, extent, width, height, render_config,
                   loop):
    """This rank's shard of the arena (N padded with dead rows to a
    multiple of the 'tile' size), its optimizer and DensifyState, and the
    Gaussian-sharded step → (state, dstate, step_fn)."""
    from ..parallel.gaussian_sharded import (
        init_sharded_train_state,
        make_gaussian_sharded_densify_step,
        shard_densify_state,
    )

    s = mesh.shape["tile"]
    n = model.num_gaussians
    params, dstate = pad_to_capacity(
        GaussianModel(*(getattr(model, f).detach().to(dev) for f in PARAMS)),
        n + (-n % s))
    state = init_sharded_train_state(
        params, mesh, lambda m: make_optimizer(m, scene_extent=extent))
    step_fn = make_gaussian_sharded_densify_step(
        width, height, mesh, render_config, loop.lambda_dssim)
    return state, shard_densify_state(dstate, mesh), step_fn


def train(
    model,
    views: List[View],
    width: int,
    height: int,
    render_config: RenderConfig = RenderConfig(),
    loop: TrainLoopConfig = TrainLoopConfig(),
    on_log: Optional[Callable[[int, float, int], None]] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    device="cuda",
    mesh=None,
):
    """Run the full training loop on `device`. Returns (state, dstate).

    With `checkpoint_dir`: resumes from the stored loop state when the
    directory holds one, and saves the loop state (model, optimizer,
    DensifyState, iteration) every `checkpoint_every` iterations when that
    is > 0. The view-sampling RNG restarts from `loop.seed` on resume.
    In a process group every rank trains the same replicated loop: rank 0
    alone writes the loop state, and every rank waits at a barrier before
    it looks for one to resume from.

    With a `mesh` (`parallel.make_mesh`) whose 'tile' axis S is greater
    than 1, the arena is Gaussian-sharded instead: N is padded with dead
    rows to a multiple of S, each rank holds its N/S rows, their Adam
    moments and DensifyState (`parallel.shard_model`,
    `init_sharded_train_state`), and every rank takes
    `parallel.make_gaussian_sharded_densify_step` on the same view order
    (its banded a2a exchange). The state
    returned is this rank's shard (`parallel.gather_sharded_model` gathers
    the model). Densification rounds, opacity resets and `checkpoint_dir`
    raise NotImplementedError on that path (`_refuse_on_sharded_arena`),
    and a run whose exchange cut rows raises RuntimeError at the next log
    line or after the last step (`_raise_on_overflow`)."""
    dev = resolve_device(device)
    extent = scene_extent(views)
    sharded = mesh is not None and mesh.shape["tile"] > 1
    if sharded:
        _refuse_on_sharded_arena(loop, checkpoint_dir)
        state, dstate, step_fn = _sharded_arena(
            model, mesh, dev, extent, width, height, render_config, loop)
    else:
        capacity = int(model.num_gaussians * loop.capacity_factor)
        params, dstate = pad_to_capacity(   # leaves the caller's model alone
            GaussianModel(*(getattr(model, f).detach().to(dev)
                            for f in PARAMS)), capacity)
        state = TrainState(model=params, optimizer=make_optimizer(
            params, scene_extent=extent))
        step_fn = make_densify_train_step(width, height, render_config,
                                          loop.lambda_dssim)
    generator = torch.Generator().manual_seed(loop.seed)
    rng = np.random.default_rng(loop.seed)
    targets = [torch.as_tensor(np.asarray(v.image, np.float32), device=dev)
               for v in views]
    cameras = [v.camera.to(dev) for v in views]
    max_sh = state.model.max_sh_degree

    it = 0
    writer = not dist.is_initialized() or dist.get_rank() == 0
    if checkpoint_dir:
        from .checkpoint import (
            has_checkpoint,
            restore_loop_state,
            save_loop_state,
        )

        if dist.is_initialized():
            dist.barrier()   # rank 0's writes (and --fresh) come first
        if has_checkpoint(checkpoint_dir):
            state, dstate, it = restore_loop_state(checkpoint_dir, state,
                                                   dstate)
            print(f"resumed from {checkpoint_dir} at iteration {it}",
                  file=sys.stderr)

    t0 = time.time()
    start_it = it
    loss = torch.full((), float("nan"))
    while it < loop.iterations:
        sh_degree = min((it + 1) // loop.sh_upgrade_every, max_sh)
        vi = int(rng.integers(len(views)))
        state, dstate, loss = step_fn(state, dstate, cameras[vi],
                                      targets[vi], sh_degree)
        it += 1

        if (loop.densify_from <= it <= loop.densify_until
                and it % loop.densify_every == 0):
            late = it >= loop.world_prune_from
            _, dstate, changed = densify_and_prune(
                state.model, dstate, generator,
                grad_threshold=loop.grad_threshold,
                percent_dense=loop.percent_dense,
                scene_extent=extent,
                min_opacity=loop.min_opacity,
                max_world_radius_frac=(loop.world_radius_frac if late
                                       else None),
                max_screen_size=loop.screen_size_px if late else None,
            )
            reset_opt_rows(state.optimizer, changed)

        if it % loop.opacity_reset_every == 0:
            reset_opacity(state.model, dstate.alive)
            reset_opt_opacity(state.optimizer, state.model.opacity_logit)

        if (writer and checkpoint_dir and checkpoint_every
                and it % checkpoint_every == 0):
            save_loop_state(state, dstate, it, checkpoint_dir)

        if it % loop.log_every == 0 and (writer or not sharded):
            # rank 0 logs a sharded arena, where no round changes the rows
            alive = (model.num_gaussians if sharded
                     else int(dstate.alive.sum()))
            if on_log is not None:
                on_log(it, float(loss), alive)
            else:
                print(f"iter {it:6d}  loss {float(loss):.4f}  "
                      f"gaussians {alive}  sh {sh_degree}  "
                      f"{(time.time() - t0) / (it - start_it) * 1e3:.0f} "
                      "ms/it", file=sys.stderr)
        if sharded and (it % loop.log_every == 0 or it == loop.iterations):
            _raise_on_overflow(step_fn, it)   # a sync the log line makes
    return state, dstate
