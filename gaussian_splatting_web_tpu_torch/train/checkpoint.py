"""Checkpoint and resume, the port of the JAX package's
`train/checkpoint.py`:

  * `save_ply` / `load_ply_model`: the interchange format (io.ply);
  * `save_train_state` / `restore_train_state`: the TrainState (model,
    optimizer moments, step), what `cli train --checkpoint` leaves in
    `<checkpoint>-final`;
  * `save_loop_state` / `restore_loop_state`: the whole training-loop state
    (model, optimizer moments, step, DensifyState, iteration).

Both go through `torch.save` into one file in the directory (a temporary
file first, then a rename), in place of the JAX package's orbax; neither
package reads the other's checkpoints.
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
TRAIN_STATE = "train_state.pt"


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


def _save(blob: dict, path: str, name: str) -> None:
    """torch.save into <path>/<name> through a temporary file, so an
    interrupted save leaves the previous file readable."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, name + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, name))


def _state_blob(state: TrainState) -> dict:
    return {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(), "step": state.step}


def _load_state(blob: dict, state: TrainState) -> TrainState:
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    return state


def save_train_state(state: TrainState, path: str) -> None:
    """Persist the TrainState (model, optimizer moments, step) into the
    directory `path`."""
    _save(_state_blob(state), path, TRAIN_STATE)


def restore_train_state(path: str, template: TrainState) -> TrainState:
    """Restore into `template`, a state built for the same model shape and
    optimizer, in place → the template."""
    blob = torch.load(os.path.join(path, TRAIN_STATE),
                      map_location=template.model.device, weights_only=True)
    return _load_state(blob, template)


def save_loop_state(state: TrainState, dstate: DensifyState, it: int,
                    path: str) -> None:
    """Persist the full loop state (the TrainState, DensifyState and
    iteration) into the directory `path`."""
    blob = _state_blob(state)
    blob["dstate"] = {f.name: getattr(dstate, f.name)
                      for f in dataclasses.fields(dstate)}
    blob["it"] = it
    _save(blob, path, LOOP_STATE)


def restore_loop_state(path: str, state: TrainState,
                       dstate: DensifyState):
    """Inverse of save_loop_state into a state built for the same capacity
    and optimizer → (state, dstate, it)."""
    blob = torch.load(os.path.join(path, LOOP_STATE),
                      map_location=state.model.device, weights_only=True)
    state = _load_state(blob, state)
    return state, DensifyState(**blob["dstate"]), int(blob["it"])
