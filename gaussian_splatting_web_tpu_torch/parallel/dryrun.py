"""A dry run of the port's multi-rank training: one tile-sharded step, one
Gaussian-sharded step and one banded Gaussian-sharded step on a tiny
scene (the counterpart of `dryrun_multichip` in the JAX package's
`__graft_entry__.py`).

    python -m gaussian_splatting_web_tpu_torch.parallel.dryrun [N]
        spawns N NCCL ranks, one on each of the first N cards
    python -m gaussian_splatting_web_tpu_torch.parallel.dryrun [N] --device cpu
        spawns N gloo ranks on the CPU (default N = 4)
    torchrun --nproc-per-node N -m gaussian_splatting_web_tpu_torch.parallel.dryrun N [--device cpu]
        runs in torchrun's group: NCCL on the cards, gloo with --device cpu
"""

from __future__ import annotations

import argparse
import datetime
import os
import tempfile
import types
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import RenderConfig
from ..core.camera import default_camera
from ..core.types import GaussianCloud
from ..models.gaussian_model import GaussianModel
from ..train.trainer import TrainState
from .gaussian_sharded import (
    init_sharded_train_state,
    make_gaussian_sharded_train_step,
)
from .mesh import make_mesh
from .multihost import initialize_multihost
from .train_sharded import make_sharded_train_step

WIDTH, HEIGHT, N_SPLATS = 64, 48, 128
CONFIG = RenderConfig(max_dup=16, max_per_tile=32, tile_chunk=2)


def tiny_scene(n: int = N_SPLATS, seed: int = 0,
               sh_degree: int = 1) -> GaussianCloud:
    """The JAX dry run's scene (`__graft_entry__._tiny_scene`), from the
    same numpy draws."""
    rng = np.random.default_rng(seed)
    k = {0: 1, 1: 4, 2: 9, 3: 16}[sh_degree]
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return GaussianCloud.from_numpy(types.SimpleNamespace(
        xyz=rng.normal(size=(n, 3)),
        log_scale=rng.uniform(-3.5, -1.5, size=(n, 3)),
        quat=q,
        opacity_logit=rng.uniform(-2, 2, size=(n,)),
        sh=rng.normal(scale=0.3, size=(n, k, 3))))


def _adam(model: GaussianModel) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=1e-3)


def run_steps(device) -> Dict[str, float]:
    """The three steps in the current process group (or alone on a 1 × 1
    mesh), on `device`; every rank calls it. Rank 0 prints the losses."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(data=data)
    cloud = tiny_scene().to(device)
    cams = [default_camera(WIDTH, HEIGHT, eye=(0, i * 0.5, -6),
                           center=(0, 0, 0)).to(device) for i in range(data)]
    targets = torch.zeros((data, HEIGHT, WIDTH, 3), device=device)
    say = (not dist.is_initialized()) or dist.get_rank() == 0
    losses = {}

    model = GaussianModel.from_cloud(cloud)
    state = TrainState(model, _adam(model))
    state, loss = make_sharded_train_step(WIDTH, HEIGHT, mesh, CONFIG)(
        state, cams, targets)
    losses["tile_sharded"] = float(loss)
    if say:
        print(f"dryrun_multichip({n}): mesh={mesh.shape} "
              f"loss={losses['tile_sharded']:.5f} step={state.step}")

    for name, banded in (("gaussian_sharded", False),
                         ("gaussian_sharded_banded", True)):
        state = init_sharded_train_state(GaussianModel.from_cloud(cloud),
                                         mesh, _adam)
        step = make_gaussian_sharded_train_step(WIDTH, HEIGHT, mesh, CONFIG,
                                                banded=banded)
        state, loss, aux = step(state, cams, targets)
        losses[name] = float(loss)
        if say:
            print(f"dryrun_multichip({n}) {name.replace('_', '-')}: "
                  f"loss={losses[name]:.5f} step={state.step} "
                  f"overflow={int(aux['overflow'])}")
    return losses


def _rank(rank: int, n_ranks: int, folder: str, device_type: str) -> None:
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device, backend = torch.device("cuda", rank), "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=f"file://{folder}/store",
                            world_size=n_ranks, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        losses = run_steps(device)
        if rank == 0:
            torch.save(losses, os.path.join(folder, "losses.pt"))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_ranks: int, device: str = "cuda") -> Dict[str, float]:
    """One tile-sharded, one Gaussian-sharded and one banded step at 64×48
    with 128 splats on n_ranks ranks; prints and returns the three losses.
    Inside an initialised process group of n_ranks ranks every rank calls
    it and it runs there: NCCL for `device` cuda, gloo for the CPU.
    Otherwise it spawns n_ranks processes: NCCL ranks on the first n_ranks
    cards, or gloo ranks for device "cpu"."""
    kind = torch.device(device).type
    if dist.is_initialized():
        if dist.get_world_size() != n_ranks:
            raise ValueError(f"dryrun_multichip({n_ranks}) in a group of "
                             f"{dist.get_world_size()} ranks")
        backend = dist.get_backend()
        if (backend == "nccl") != (kind == "cuda"):
            raise ValueError(f"dryrun_multichip(device={device!r}) in a "
                             f"{backend} group")
        return run_steps(torch.device("cuda", torch.cuda.current_device())
                         if kind == "cuda" else "cpu")
    if kind == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < n_ranks:
            raise RuntimeError(
                f"dryrun_multichip({n_ranks}) on {device}: {cards} CUDA "
                "device(s) available; pass device='cpu' (--device cpu) for "
                "gloo ranks on the CPU, or run it under torchrun")
    with tempfile.TemporaryDirectory() as folder:
        mp.spawn(_rank, args=(n_ranks, folder, kind), nprocs=n_ranks,
                 join=True)
        return torch.load(os.path.join(folder, "losses.pt"))


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m gaussian_splatting_web_tpu_torch.parallel.dryrun")
    p.add_argument("n_ranks", type=int, nargs="?", default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda (NCCL ranks on the cards, the default) or "
                        "cpu (gloo ranks)")
    args = p.parse_args(argv)
    if initialize_multihost(device=args.device):
        try:
            dryrun_multichip(args.n_ranks, args.device)
        finally:
            dist.destroy_process_group()
    else:
        dryrun_multichip(args.n_ranks, args.device)


if __name__ == "__main__":
    main()
