#!/usr/bin/env python3
"""Where a training step's time goes on one NVIDIA GPU.

    python3 profile_train.py [--splats 1000000] [--width 1920] [--height 1080]

Builds the port's training step (`train/train_loop.py::
make_densify_train_step`) on `make_scene(splats, seed=0)` in a 2x arena,
fitting four views that `render` made of `make_scene(splats, seed=1)`, as
`chip_smoke.py` phase 8 does. After warm-up it prints:

  * the step split by the host clock with a synchronize between stages:
    forward (project + bin + composite + loss), backward, Adam;
  * `torch.profiler` over 10 steps: device time per kernel name (top 25,
    kernels A and B among them), and device busy time against wall time
    (the idle share).

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import statistics
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from gaussian_splatting_web_tpu_torch.bench_lib import make_scene
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core.camera import default_camera
from gaussian_splatting_web_tpu_torch.models.gaussian_model import (
    GaussianModel,
)
from gaussian_splatting_web_tpu_torch.ops.projection import project_gaussians
from gaussian_splatting_web_tpu_torch.ops.rasterize import (
    rasterize_tiles,
    render,
)
from gaussian_splatting_web_tpu_torch.ops.sort import bin_splats
from gaussian_splatting_web_tpu_torch.train.densify import pad_to_capacity
from gaussian_splatting_web_tpu_torch.train.loss import (
    full_f32,
    photometric_loss,
)
from gaussian_splatting_web_tpu_torch.train.train_loop import (
    make_densify_train_step,
)
from gaussian_splatting_web_tpu_torch.train.trainer import (
    TrainState,
    apply_gradients,
    make_optimizer,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--splats", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train.py needs a CUDA device")
    dev = torch.device("cuda")
    w, h = args.width, args.height
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    full_f32()
    cfg = RenderConfig()

    cameras, targets = [], []
    with torch.no_grad():
        scene = make_scene(args.splats, seed=1, device=dev)
        for i in range(4):
            a = 2 * math.pi * i / 4
            cam = default_camera(w, h, eye=(8 * math.sin(a), 0.5,
                                            -8 * math.cos(a)),
                                 center=(0, 0, 0)).to(dev)
            cameras.append(cam)
            targets.append(render(scene, cam, w, h, cfg)[0])
        del scene
    model, dstate = pad_to_capacity(GaussianModel.from_cloud(
        make_scene(args.splats, seed=0, device=dev)), 2 * args.splats)
    state = TrainState(model, make_optimizer(model, scene_extent=8.8))
    step = make_densify_train_step(w, h, cfg, 0.2)

    def run(i):
        nonlocal state, dstate
        state, dstate, loss = step(state, dstate, cameras[i % 4],
                                   targets[i % 4], 3)
        return loss

    for i in range(5):
        run(i)
    torch.cuda.synchronize()

    # stage split: host clock, synchronize between stages
    split = {"forward": [], "backward": [], "adam": [], "step": []}
    for i in range(7):
        cam, target = cameras[i % 4], targets[i % 4]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state.optimizer.zero_grad(set_to_none=True)
        splats = project_gaussians(model.to_cloud(3), cam, w, h, cfg)
        vs_aux = torch.zeros((model.num_gaussians, 2), device=dev,
                             requires_grad=True)
        splats = dataclasses.replace(splats, mean2d=splats.mean2d + vs_aux)
        bins = bin_splats(splats, w, h, cfg)
        out = rasterize_tiles(splats, bins, w, h, cfg)
        loss = photometric_loss(out.rgb, target, 0.2)   # black background
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        apply_gradients(state)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        run(i)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        split["forward"].append((t1 - t0) * 1e3)
        split["backward"].append((t2 - t1) * 1e3)
        split["adam"].append((t3 - t2) * 1e3)
        split["step"].append((t4 - t3) * 1e3)
    print("stage medians ms (host clock, synchronized): " + ", ".join(
        f"{k} {statistics.median(v):.2f}" for k, v in split.items()))

    steps = 10
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            run(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # kernels only: the optimizer's range annotation also shows on the
    # device timeline and would count its kernels twice
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("Optimizer.")]
    busy = sum(e.device_time_total for e in events) / 1e3
    print(f"profiled {steps} steps: wall {wall:.2f} ms "
          f"({wall / steps:.2f} ms/step), device busy {busy:.2f} ms, "
          f"idle share {1 - busy / wall:.3f}")
    events.sort(key=lambda e: -e.device_time_total)
    for e in events[:25]:
        print(f"  {e.device_time_total / 1e3 / steps:8.3f} ms/step "
              f"{e.count // steps:5d} launches/step  {e.key[:90]}")


if __name__ == "__main__":
    main()
