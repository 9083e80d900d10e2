"""Checkpoint and resume, the port of the JAX package's
`train/checkpoint.py`:

  * `save_ply` / `load_ply_model`: the interchange format (io.ply);
  * `save_loop_state` / `restore_loop_state`: the whole training-loop state
    (model, optimizer moments, step, DensifyState, iteration) through
    `torch.save` into `<dir>/loop_state.pt`, in place of orbax.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from ..io.ply import read_ply, write_ply
from ..models.gaussian_model import GaussianModel
from .densify import DensifyState
from .trainer import TrainState

LOOP_STATE = "loop_state.pt"


def save_ply(state_or_model, path: str,
             active_sh_degree: Optional[int] = None) -> None:
    model = (state_or_model.model if isinstance(state_or_model, TrainState)
             else state_or_model)
    with torch.no_grad():
        write_ply(model.to_cloud(active_sh_degree), path)


def load_ply_model(path: str, device="cuda") -> GaussianModel:
    return GaussianModel.from_cloud(read_ply(path, device=device))


def has_checkpoint(path: Optional[str]) -> bool:
    return bool(path) and os.path.isdir(path) and bool(os.listdir(path))


def save_loop_state(state: TrainState, dstate: DensifyState, it: int,
                    path: str) -> None:
    """Persist the full loop state; written to a temporary file first, so
    an interrupted save leaves the previous state readable."""
    os.makedirs(path, exist_ok=True)
    blob = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "dstate": {f.name: getattr(dstate, f.name)
                   for f in dataclasses.fields(dstate)},
        "it": it,
    }
    tmp = os.path.join(path, LOOP_STATE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, LOOP_STATE))


def restore_loop_state(path: str, state: TrainState,
                       dstate: DensifyState):
    """Inverse of save_loop_state into a state built for the same capacity
    and optimizer → (state, dstate, it)."""
    dev = state.model.device
    blob = torch.load(os.path.join(path, LOOP_STATE), map_location=dev,
                      weights_only=True)
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    dstate = DensifyState(**blob["dstate"])
    return state, dstate, int(blob["it"])
