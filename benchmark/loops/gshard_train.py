"""The "gshard_train" loop: a closed loop of the program's Gaussian-sharded
training step, the step `train()` takes on a mesh whose 'tile' axis is
greater than 1 (`parallel/gaussian_sharded.py::
make_gaussian_sharded_densify_step`), one process per card.

Processes. Rank 0 is `benchmark/run.py`'s process, on its first card. It
imports the step first (a port without it fails here, before any other
process starts), builds the port's kernels, then starts ranks 1 .. S-1 as
`python benchmark/loops/gshard_train.py --worker ...` on the next cards.
A worker dies with rank 0 (PR_SET_PDEATHSIG), and rank 0 ends the run when
a worker exits with an error (a watcher thread), so a run never hangs. The
ranks join one process group over a localhost TCP store: NCCL on the cards
(gloo on the CPU) for the step, and a gloo group beside it for what the
hosts agree on; both time out.

Inputs. Every rank makes the seed's scene, keeps its shard (rows [t N/S,
(t+1) N/S), which is what `shard_model` gives) and makes the targets; the
arena equals N with every row live, as in the "train" loop. The set-up
takes `warm_steps` steps on views that all differ; the reference follows the
first `checked_steps` of them.

The window. Every rank steps through the same seeded epochs of the
training views. The window's rule: after each step rank 0 reads its host
clock and broadcasts "stop" over the gloo group once `seconds` have passed
since the window opened; every rank stops after the same step. The
broadcast is of a host tensor, so no rank waits for its card during the
window; each syncs its card once, at the end. `train_step_ms` is rank 0's
window over the steps, `train_peak_gib` the largest peak over the ranks.

The check. Each step's loss (the same on every rank), the first gradient's
norm per leaf (from each shard's first Adam moment) and the norm of each
leaf's change after the checked steps, the sums of squares added up over
the shards; and `overflow`, the rows the exchange cut over every step,
which must be 0 (a step that cut any counts in `failed`). Once the
program's state and targets are freed, rank 0 runs the reference
(`reference/blocked.py`) on the whole scene.

Traffic parameters: `sh_degree`, `warm_steps`, `checked_steps`, `mesh`
{"data", "tile"}, `banded`, `stream`, `cand_factor`, and `limits` for
`loss_rel`, `grad_norm_gap`, `change_norm_gap` and `overflow`.
"""

from __future__ import annotations

import argparse
import ctypes
import datetime
import json
import math
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[2]
if __name__ == "__main__":
    # a worker: import the benchmark as a package from the checkout's root,
    # never this folder's modules by their bare names
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != here]

from benchmark import check, harness, inputs as inp  # noqa: E402
from benchmark.loops.train import ProgramTrainer, half_batch  # noqa: E402
from benchmark.reference import blocked, full_f32  # noqa: E402

RENDEZVOUS_S = 300     # the workers' start, the NCCL collectives
HOST_S = 1800          # the gloo group: the workers wait out the reference
KERNELS = ("raster_fwd", "raster_bwd", "project")


def _world(traffic: dict) -> int:
    return traffic["mesh"]["data"] * traffic["mesh"]["tile"]


class Group:
    """This rank's place in the process group: the mesh for the step, and
    the gloo group `host` for host tensors."""

    def __init__(self, rank: int, world: int, port: int, device,
                 traffic: dict):
        from gaussian_splatting_web_tpu_torch.parallel import make_mesh

        self.rank, self.world = rank, world
        cuda = torch.device(device).type == "cuda"
        dist.init_process_group(
            "nccl" if cuda else "gloo",
            init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=RENDEZVOUS_S))
        self.host = (dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=HOST_S))
            if cuda else dist.group.WORLD)
        self.mesh = make_mesh(data=traffic["mesh"]["data"],
                              tile=traffic["mesh"]["tile"])

    def sum(self, values: Dict[str, float]) -> Dict[str, float]:
        """Each value added up over the ranks (float64, on the host)."""
        keys = sorted(values)
        t = torch.tensor([values[k] for k in keys], dtype=torch.float64)
        dist.all_reduce(t, group=self.host)
        return dict(zip(keys, t.tolist()))

    def gather(self, obj) -> list:
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.host)
        return out

    def close(self) -> None:
        dist.destroy_process_group()


class ShardTrainer(ProgramTrainer):
    """The "train" loop's trainer over this rank's shard of the arena (its
    rows, their optimizer and DensifyState), taking the program's
    Gaussian-sharded step, as `train()` builds them."""

    def __init__(self, cfg: dict, traffic: dict, shard: dict, extent: float,
                 mesh):
        from gaussian_splatting_web_tpu_torch.parallel import (
            make_gaussian_sharded_densify_step,
        )

        super().__init__(dict(cfg, num_gaussians=shard["xyz"].shape[0]),
                         shard, extent, None)
        self.step_fn = make_gaussian_sharded_densify_step(
            cfg["width"], cfg["height"], mesh,
            harness.program_render_config(cfg), cfg["train"]["lambda_dssim"],
            banded=traffic["banded"], cand_factor=traffic["cand_factor"],
            stream=traffic["stream"])

    def grad_sq(self) -> Dict[str, float]:
        """Per leaf, the squared norm of this shard's first gradient, from
        the first moment after one step: m_1 = (1 - beta1) g_1."""
        return {k: _sq(self._moment(k)) / (1.0 - self.beta1) ** 2
                for k in inp.LEAVES}

    def change_sq(self, shard0: dict) -> Dict[str, float]:
        return {k: _sq(getattr(self.params, k).detach(), shard0[k])
                for k in inp.LEAVES}


def _sq(a: torch.Tensor, b: Optional[torch.Tensor] = None,
        rows: int = 1 << 20) -> float:
    """The squared norm of `a` (of a - b), summed in float64 a block of
    rows at a time (no copy of the whole leaf)."""
    total = 0.0
    for r in range(0, a.shape[0], rows):
        x = a[r:r + rows].double()
        if b is not None:
            x = x - b[r:r + rows].to(a.device).double()
        total += float((x * x).sum())
    return total


def make_shard(cfg: dict, seed: int, device, mesh):
    """The seed's inputs with the scene cut to this rank's rows → (Inputs
    with `scene` None, the shard's leaves on the device)."""
    from gaussian_splatting_web_tpu_torch.parallel.mesh import AXES

    data = inp.make_inputs(cfg, seed, device)
    s, t = mesh.shape[AXES.tile], mesh.tile_index
    n_s = cfg["num_gaussians"] // s
    shard = {k: v[t * n_s:(t + 1) * n_s].clone()
             for k, v in data.scene.items()}
    data.scene = None
    return data, shard


def first_steps(trainer: ShardTrainer, group: Group, cams, targets, row,
                order, traffic: dict, shard0: dict, steps: int) -> dict:
    """`steps` steps on the first views of `order` and the readings of the
    first `checked_steps`: each loss, the first gradient's norm and the
    change's norm per leaf, over the whole scene."""
    sh = traffic["sh_degree"]
    checked = traffic["checked_steps"]
    prog = {"loss": []}
    for k in range(steps):
        v = order[k]
        loss = trainer.step(cams[v], targets[row[v]], sh)
        if k < checked:
            prog["loss"].append(float(loss))
        if k == 0:
            prog["grad_norm"] = {k2: math.sqrt(x) for k2, x in
                                 group.sum(trainer.grad_sq()).items()}
        if k == checked - 1:
            prog["change_norm"] = {k2: math.sqrt(x) for k2, x in
                                   group.sum(trainer.change_sq(shard0))
                                   .items()}
    return prog


def _loaded_jax() -> list:
    from benchmark.run import loaded_jax

    return loaded_jax()


def rank_run(rank: int, world: int, port: int, cfg: dict, traffic: dict,
             seed: int, seconds: float, traced: bool, device,
             setup_clock) -> Optional[dict]:
    """One rank's part of a run. Rank 0 returns the run's parts (the
    program's readings, the window's numbers, the profiler); the others
    None."""
    group = Group(rank, world, port, device, traffic)
    try:
        data, shard = make_shard(cfg, seed, device, group.mesh)
        targets = inp.make_targets(cfg, seed, len(data.train_ids), device)
        row = {v: r for r, v in enumerate(data.train_ids)}
        harness.sync(device)
        if rank == 0:
            harness.mark("inputs", setup_clock)
        shard0 = {k: v.cpu() for k, v in shard.items()}
        trainer = ShardTrainer(cfg, traffic, shard, data.extent, group.mesh)
        del shard
        cams = {i: harness.program_camera(data.cameras[i])
                for i in data.train_ids}
        warm, checked = traffic["warm_steps"], traffic["checked_steps"]
        order = inp.request_order(data.train_ids, warm + 100_000, seed,
                                  shuffle=True)
        prog = first_steps(trainer, group, cams, targets, row, order,
                           traffic, shard0, warm)
        del shard0
        harness.sync(device)
        setup_s = setup_clock()
        if rank == 0:
            harness.mark("warm-up", setup_clock)

        sh = traffic["sh_degree"]
        stop = torch.zeros(1, dtype=torch.int32)
        losses: List[torch.Tensor] = []
        cut_steps = torch.zeros((), dtype=torch.int64, device=device)
        prof = harness.profiler(device) if traced and rank == 0 else None
        with harness.maybe(prof, "trace stop"), \
                harness.window_range(prof is not None):
            t0 = time.perf_counter()
            n = 0
            while True:
                v = order[warm + n]
                losses.append(trainer.step(cams[v], targets[row[v]], sh))
                cut_steps += trainer.step_fn.last_overflow > 0
                n += 1
                if rank == 0:
                    stop[0] = int(time.perf_counter() - t0 >= seconds)
                dist.broadcast(stop, 0, group=group.host)
                if stop[0]:
                    break
            harness.sync(device)
            window_s = time.perf_counter() - t0
        overflow = int(trainer.step_fn.overflow)
        failed = (int(cut_steps)
                  + sum(not math.isfinite(float(x)) for x in losses))
        peak = harness.memory_peak(device)
        checked_targets = [targets[row[v]].clone() for v in order[:checked]]
        extent = data.extent
        views = [data.cameras[v] for v in order[:checked]]
        del trainer, targets, losses, cams, data
        harness.release(device)
        report = group.gather({"peak": peak, "jax": _loaded_jax()})
    finally:
        group.close()
    if rank:
        return None
    return {"prog": prog, "n": n, "window_s": window_s, "setup_s": setup_s,
            "overflow": overflow, "failed": failed, "prof": prof,
            "peaks": [r["peak"] for r in report],
            "jax": sorted({m for r in report for m in r["jax"]}),
            "views": views, "targets": checked_targets, "extent": extent}


# --- the processes -------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Workers:
    """Ranks 1 .. world-1 as child processes running `worker_main`, and a
    watcher thread that ends this process when one of them exits with an
    error while the run goes on (rank 0 would otherwise wait in a
    collective). `close` stops the watcher and kills what is left."""

    def __init__(self, args: List[str], world: int, device):
        cuda = torch.device(device).type == "cuda"
        self.procs = [
            subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                              "--worker", str(r), "--parent",
                              str(os.getpid()),
                              "--device", f"cuda:{r}" if cuda else "cpu",
                              *args], cwd=str(ROOT), stdout=sys.stderr)
            for r in range(1, world)]
        self.done = threading.Event()
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.watcher.start()

    def _watch(self) -> None:
        while not self.done.wait(0.5):
            for p in self.procs:
                rc = p.poll()
                if rc not in (None, 0):
                    print(f"gshard_train: worker {p.args[3]} exited with "
                          f"{rc}; ending the run", file=sys.stderr,
                          flush=True)
                    self.kill()
                    os._exit(1)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def close(self, clean: bool) -> None:
        self.done.set()
        self.watcher.join()
        if clean:
            for p in self.procs:
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    pass
        self.kill()
        bad = [p.returncode for p in self.procs if p.returncode]
        if clean and bad:
            raise RuntimeError(f"gshard_train: workers exited with {bad}")


def spawn(cell_args: List[str], world: int, device):
    """The port's kernels built in this process (the workers then load
    them), then the workers."""
    if torch.device(device).type == "cuda":
        from gaussian_splatting_web_tpu_torch.ops.cuda import build

        build.load_all(KERNELS)
    return Workers(cell_args, world, device)


def _args(mode: str, cfg: dict, traffic: dict, seed: int, seconds: float,
          port: int) -> List[str]:
    return ["--mode", mode, "--seed", str(seed), "--seconds", str(seconds),
            "--port", str(port), "--cell",
            json.dumps({"config": cfg, "traffic": traffic})]


def _require_port() -> None:
    """A port without the Gaussian-sharded step `train()` takes, or without
    device counters, cannot run the cell: fail before any worker starts."""
    from gaussian_splatting_web_tpu_torch.parallel import (  # noqa: F401
        make_gaussian_sharded_densify_step,
    )
    from gaussian_splatting_web_tpu_torch.utils.tracing import (  # noqa: F401
        count_device,
    )


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool, device,
        setup_clock) -> dict:
    _require_port()
    cfg, traffic = cell.config, cell.traffic
    world = _world(traffic)
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() < world:
        raise RuntimeError(f"{cell.name} needs {world} CUDA devices, "
                           f"{torch.cuda.device_count()} found")
    harness.mark("imports", setup_clock)
    port = _free_port()
    workers = spawn(_args("run", cfg, traffic, seed, seconds, port), world,
                    device)
    harness.mark("kernels", setup_clock)
    clean = False
    try:
        part = rank_run(0, world, port, cfg, traffic, seed, seconds, traced,
                        device, setup_clock)
        clean = True
    finally:
        workers.close(clean)
    if part["jax"]:
        raise RuntimeError(f"a worker loaded JAX: {part['jax']}")
    harness.mark("window", setup_clock)

    full_f32()
    scene0 = inp.make_scene(cfg, seed, device)
    ref = blocked.run_steps(scene0, part["views"], part["targets"], cfg,
                            part["extent"])
    del scene0
    harness.mark("check", setup_clock)
    numbers = dict(check.train_numbers(part["prog"], ref),
                   overflow=part["overflow"])
    peak = max(part["peaks"])
    print("peak GiB by rank " + " ".join(f"{b / 2 ** 30:.4f}"
                                         for b in part["peaks"]),
          file=sys.stderr, flush=True)
    n, window_s = part["n"], part["window_s"]
    metrics = {"train_step_ms": window_s / n * 1e3,
               "train_peak_gib": peak / 2 ** 30,
               "setup_s": part["setup_s"]}
    prof = part.pop("prof")
    ctx = harness.Context(
        loop="gshard_train", config=cfg, requests=n, window_s=window_s,
        summary=harness.reduce_trace(prof) if traced else None,
        counts=ref["counts"])
    out = harness.result(cell, numbers, metrics, ctx, n, part["failed"],
                         peak, device, traced)
    out["device"]["count"] = world
    return out


# --- the readings of tools/control.py -------------------------------------


def rank_readings(rank: int, world: int, port: int, cfg: dict, traffic: dict,
                  seed: int, device) -> Optional[dict]:
    """The program's first steps, then the same with the half-batch loss,
    on every rank; then rank 0 runs the reference and rank 1 the TF32
    control, each on its own card. Rank 0 returns the readings."""
    from gaussian_splatting_web_tpu_torch.parallel import gaussian_sharded

    group = Group(rank, world, port, device, traffic)
    checked = traffic["checked_steps"]
    try:
        data, shard = make_shard(cfg, seed, device, group.mesh)
        targets = inp.make_targets(cfg, seed, len(data.train_ids), device)
        row = {v: r for r, v in enumerate(data.train_ids)}
        cams = {i: harness.program_camera(data.cameras[i])
                for i in data.train_ids}
        order = inp.request_order(data.train_ids, checked, seed,
                                  shuffle=True)
        shard0 = {k: v.cpu() for k, v in shard.items()}
        del shard

        def program():
            trainer = ShardTrainer(
                cfg, traffic, {k: v.to(device) for k, v in shard0.items()},
                data.extent, group.mesh)
            out = first_steps(trainer, group, cams, targets, row, order,
                              traffic, shard0, checked)
            del trainer
            harness.release(device)
            return out

        prog = program()
        orig = gaussian_sharded.photometric_loss
        gaussian_sharded.photometric_loss = half_batch(orig)
        try:
            half = program()
        finally:
            gaussian_sharded.photometric_loss = orig
        views = [data.cameras[v] for v in order]
        tgt = [targets[row[v]].clone() for v in order]
        del targets, cams, shard0
        harness.release(device)
        side = None
        if rank < 2:
            full_f32()
            scene0 = inp.make_scene(cfg, seed, device)
            side = blocked.run_steps(scene0, views, tgt, cfg, data.extent,
                                     tf32=rank == 1)
            side.pop("counts")
        sides = group.gather(side)
    finally:
        group.close()
    if rank:
        return None
    ref, low = sides[0], sides[1]
    return {"program": check.train_numbers(prog, ref),
            "control": check.train_numbers(low, ref),
            "half_batch": check.train_numbers(half, ref),
            "leaves": {"program": prog, "reference": ref, "control": low}}


def readings(cell: harness.Cell, seed: int, device) -> dict:
    """The check's numbers for one seed (`tools/control.py`): "program",
    the program's first steps as a run checks them; "control", the
    reference computed in TF32 put in the program's place; "half_batch",
    the program with its loss taken over the top half of each image only;
    and each side's readings per leaf under "leaves"."""
    _require_port()
    cfg, traffic = cell.config, cell.traffic
    world = _world(traffic)
    port = _free_port()
    workers = spawn(_args("readings", cfg, traffic, seed, 0.0, port), world,
                    device)
    clean = False
    try:
        out = rank_readings(0, world, port, cfg, traffic, seed, device)
        clean = True
    finally:
        workers.close(clean)
    return out


# --- a worker ---------------------------------------------------------------


def worker_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, required=True)
    ap.add_argument("--parent", type=int, required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--mode", choices=("run", "readings"), required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--cell", required=True)
    args = ap.parse_args(argv)
    if sys.platform.startswith("linux"):
        # die with rank 0, whatever ends it
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    if os.getppid() != args.parent:
        return 1
    cell = json.loads(args.cell)
    cfg, traffic = cell["config"], cell["traffic"]
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    world = _world(traffic)
    if args.mode == "run":
        start = time.perf_counter()
        rank_run(args.worker, world, args.port, cfg, traffic, args.seed,
                 args.seconds, False, device,
                 lambda: time.perf_counter() - start)
    else:
        rank_readings(args.worker, world, args.port, cfg, traffic,
                      args.seed, device)
    found = _loaded_jax()
    if found:
        print(f"JAX modules were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(worker_main())
