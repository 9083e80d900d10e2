#!/usr/bin/env python3
"""The port's sharded paths across the cards of one host, held against the
unsharded path.

    torchrun --nproc-per-node 4 multichip_check.py

Every rank joins an NCCL group (`parallel/multihost.py::
initialize_multihost` from torchrun's environment; rank r drives card r)
and builds chip_smoke.py's scene: the 1M-splat SH-3 `make_scene` at
1920x1080 from the bench camera. On the mesh tile=S (S ranks):

  * `render_sharded`, `render_gaussian_sharded` and
    `render_gaussian_sharded_banded` (streams "a2a" and "ring") against the
    unsharded `render`: bit equality and the image rule
    (`bench_lib.image_rule`) where the overflow is 0, the
    overflow, E-A's launches, and the host-clock median of 3 renders;
  * one step of `make_sharded_train_step` and of the three
    `make_gaussian_sharded_train_step` variants (ring, banded a2a, banded
    ring stream) on two 1080p views, on tile=S and on data=2 × tile=S/2,
    against `bench_lib.unsharded_reference` by `bench_lib.step_parity`
    (loss rel 1e-5 and the gradient rule, over the shards put back
    together), E's launches, and the host-clock time of a second step
    (the first sets up the groups' communicators). chip_smoke.py holds the
    same steps to the same reference on one card.

Times are host clock around work that ends in synchronize and a barrier.
Rank 0 prints the card line and one JSON line; a failed check raises on
the rank that sees it, and torchrun exits non-zero. `--splats`, `--width`,
`--height` and `--device cpu` (gloo) size a rehearsal on the CPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch
import torch.distributed as dist

from gaussian_splatting_web_tpu_torch.bench_lib import (
    image_rule,
    make_scene,
    step_parity,
    unsharded_reference,
)
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core.camera import default_camera
from gaussian_splatting_web_tpu_torch.models.gaussian_model import (
    GaussianModel,
)
from gaussian_splatting_web_tpu_torch.ops.cuda import build
from gaussian_splatting_web_tpu_torch.ops.rasterize import render
from gaussian_splatting_web_tpu_torch.parallel import (
    init_sharded_train_state,
    initialize_multihost,
    make_gaussian_sharded_train_step,
    make_mesh,
    make_sharded_train_step,
    render_gaussian_sharded,
    render_gaussian_sharded_banded,
    render_sharded,
    shard_model,
)
from gaussian_splatting_web_tpu_torch.parallel.render_sharded import (
    gather_tiles,
)
from gaussian_splatting_web_tpu_torch.train.trainer import (
    TrainState,
    make_optimizer,
)

STEPS = (("tile_sharded", None, None), ("ring", False, "a2a"),
         ("banded_a2a", True, "a2a"), ("banded_ring", True, "ring"))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"rank {dist.get_rank()}: {msg}")


def launches():
    """E-A's and E-B's launches since the last `build.reset_launches`."""
    counts = build.launch_counts()
    return (counts["E-A"], counts["E-B"])


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier()


def timed(fn, dev, runs):
    """Host-clock ms of fn() → (last result, median over `runs`)."""
    times = []
    for _ in range(runs):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def image_check(rgb, frame, overflow, what):
    res = image_rule(rgb, frame)
    if overflow == 0:
        check(res["ok"], f"{what}: outside the image rule: {res}")
    return {k: res[k] for k in ("bitwise", "max_abs_err", "bad_frac")}


def main(argv=None):
    p = argparse.ArgumentParser(prog="multichip_check.py")
    p.add_argument("--splats", type=int, default=1_000_000)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not initialize_multihost(device=args.device):
        raise SystemExit("start it under torchrun (no MASTER_ADDR)")
    try:
        run(args)
    finally:
        dist.destroy_process_group()


def run(args):
    rank, s = dist.get_rank(), dist.get_world_size()
    w, h = args.width, args.height
    if args.device == "cpu":
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if rank == 0:
            build.load_all(("raster_fwd", "raster_bwd"))
        dist.barrier()
    cfg = RenderConfig()
    cloud = make_scene(args.splats, seed=0, sh_degree=3, device=dev)
    camera = default_camera(w, h, eye=(0, 0, -8), center=(0, 0, 0)).to(dev)
    with torch.no_grad():
        frame, _ = render(cloud, camera, w, h, cfg)
    out = {"ranks": s, "splats": args.splats, "frame": [w, h],
           "renders": {}, "steps": {}}

    mesh = make_mesh(tile=s)
    shard = shard_model(cloud, mesh)
    renders = {
        "tile_sharded": lambda: (*render_sharded(cloud, camera, w, h, mesh,
                                                 cfg), 0),
        "ring": lambda: (*render_gaussian_sharded(shard, camera, w, h, mesh,
                                                  cfg), 0),
        "banded_a2a": lambda: render_gaussian_sharded_banded(
            shard, camera, w, h, mesh, cfg, stream="a2a"),
        "banded_ring": lambda: render_gaussian_sharded_banded(
            shard, camera, w, h, mesh, cfg, stream="ring"),
    }
    for name, fn in renders.items():
        build.reset_launches()
        with torch.no_grad():
            rgb, _, over = fn()
            sync(dev)
            n_ea = launches()[0]
            (rgb, _, over), ms = timed(fn, dev, 3)
        over = int(over)
        res = image_check(rgb, frame, over, name)
        if dev.type == "cuda":
            check(n_ea == 1, f"{name} render launched E-A {n_ea} times")
        out["renders"][name] = {**res, "overflow": over, "e_a": n_ea,
                                "ms": ms}

    ref = unsharded_reference(cloud, w, h, cfg)
    cams, targets, ref_loss, names = ref[0], ref[1], ref[2], list(ref[3])

    meshes = {f"tile{s}": mesh}
    if s % 2 == 0 and s > 2:
        meshes[f"data2xtile{s // 2}"] = make_mesh(data=2)
    for mname, m in meshes.items():
        views = len(cams) // m.shape["data"]
        for name, banded, stream in STEPS:
            model = GaussianModel.from_cloud(cloud)
            if banded is None:
                state = TrainState(model, make_optimizer(model))
                step = make_sharded_train_step(w, h, m, cfg)
            else:
                state = init_sharded_train_state(model, m)
                step = make_gaussian_sharded_train_step(
                    w, h, m, cfg, banded=banded, stream=stream)
            del model
            build.reset_launches()
            result = step(state, cams, targets)
            sync(dev)
            n_e = launches()
            loss = float(result[1])
            over = int(result[2]["overflow"]) if banded is not None else 0
            got = [getattr(state.model, f).grad for f in names]
            if banded is not None:    # the shards, put back in tile order
                got = [gather_tiles(g, m) for g in got]
            parity = step_parity(loss, got, ref)
            rel, stats = parity["rel"], parity["stats"]
            if over == 0:
                check(parity["ok"], f"{mname} {name}: loss {loss} vs "
                      f"unsharded {ref_loss} (rel {rel:.2e}), gradients "
                      f"{stats}")
            if dev.type == "cuda":
                check(n_e == (views, views),
                      f"{mname} {name}: E launched {n_e} on {views} views")
            _, ms = timed(lambda: step(state, cams, targets), dev, 1)
            out["steps"][f"{mname} {name}"] = {
                "loss": loss, "rel": rel, "overflow": over,
                "grad_p99": stats["p99"], "grad_nbig": stats["nbig"],
                "bitwise": parity["bitwise"],
                "e_a_e_b": list(n_e), "second_step_ms": ms}
            del state, step, got

    if rank == 0:
        if dev.type == "cuda":
            print(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60, check=True).stdout.strip())
            out["device"] = torch.cuda.get_device_name(dev)
        print(json.dumps(out))


if __name__ == "__main__":
    main()
