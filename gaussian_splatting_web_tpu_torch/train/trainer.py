"""Single-device training: optimizer, train state and train step, the port
of the JAX package's `train/trainer.py`.

The optimizer is INRIA's per-group Adam (eps 1e-15): positions get a
learning rate scaled by the scene extent that decays exponentially like
`optax.exponential_decay` (continuous, clipped at its end value) and is
evaluated at the count of updates taken so far, as optax evaluates it;
SH rest bands learn at the DC rate / 20. Here the groups are parameter
groups of the port's Adam (`ops/cuda/adam.py`: torch's groups and state,
one launch of `csrc/adam.cu` a step on the card) over the GaussianModel's
parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..config import RenderConfig
from ..core.types import CameraParams
from ..models.gaussian_model import GaussianModel
from ..ops.cuda.adam import Adam
from ..ops.rasterize import render_impl
from ..utils import tracing
from .loss import full_f32, photometric_loss


def exponential_decay(step: int, init: float, steps: int, rate: float,
                      end: float) -> float:
    """optax.exponential_decay(init, steps, rate, end_value=end) at `step`."""
    value = init * rate ** (step / steps)
    return max(value, end) if rate < 1.0 else min(value, end)


def make_optimizer(
    model: GaussianModel,
    scene_extent: float = 1.0,
    position_lr: float = 1.6e-4,
    position_lr_final: float = 1.6e-6,
    position_lr_max_steps: int = 30_000,
    sh_dc_lr: float = 2.5e-3,
    sh_rest_lr_div: float = 20.0,
    opacity_lr: float = 0.05,
    scale_lr: float = 5e-3,
    quat_lr: float = 1e-3,
) -> torch.optim.Adam:
    """INRIA per-group Adam over `model`'s parameters. The position group
    carries its schedule under "lr_decay" (see `set_learning_rates`)."""
    decay = {"init": position_lr * scene_extent,
             "steps": position_lr_max_steps,
             "rate": position_lr_final / position_lr,
             "end": position_lr_final * scene_extent}
    groups = [
        {"params": [model.xyz], "lr": decay["init"], "name": "xyz",
         "lr_decay": decay},
        {"params": [model.log_scale], "lr": scale_lr, "name": "scale"},
        {"params": [model.quat], "lr": quat_lr, "name": "quat"},
        {"params": [model.opacity_logit], "lr": opacity_lr,
         "name": "opacity"},
        {"params": [model.sh_dc], "lr": sh_dc_lr, "name": "sh_dc"},
        {"params": [model.sh_rest], "lr": sh_dc_lr / sh_rest_lr_div,
         "name": "sh_rest"},
    ]
    return Adam(groups, eps=1e-15)


def set_learning_rates(optimizer: torch.optim.Optimizer, step: int) -> None:
    """Evaluate each scheduled group's learning rate at `step`, the number
    of updates taken so far (optax's count)."""
    for group in optimizer.param_groups:
        if "lr_decay" in group:
            group["lr"] = exponential_decay(step, **group["lr_decay"])


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the number of steps taken. Steps update
    the model's parameters and the optimizer's moments in place."""

    model: GaussianModel
    optimizer: torch.optim.Adam
    step: int = 0


@tracing.spanned("adam")
def apply_gradients(state: TrainState) -> None:
    """One Adam update from the gradients in the parameters' .grad."""
    set_learning_rates(state.optimizer, state.step)
    state.optimizer.step()
    state.step += 1


def make_train_step(
    width: int,
    height: int,
    config: RenderConfig = RenderConfig(),
    lambda_dssim: float = 0.2,
    active_sh_degree: Optional[int] = None,
) -> Callable[[TrainState, CameraParams, torch.Tensor],
              Tuple[TrainState, torch.Tensor]]:
    """Build a (state, camera, target [H, W, 3]) → (state, loss) step on
    the model's device. Turns TF32 off (`loss.full_f32`)."""
    full_f32()

    def step(state: TrainState, camera: CameraParams, target: torch.Tensor):
        state.optimizer.zero_grad(set_to_none=True)
        img, _ = render_impl(state.model.to_cloud(active_sh_degree), camera,
                             width, height, config)
        loss = photometric_loss(img, target.to(img.device), lambda_dssim)
        loss.backward()
        apply_gradients(state)
        return state, loss.detach()

    return step
