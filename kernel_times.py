#!/usr/bin/env python3
"""Kernels A and B of a checkout, each timed alone, at the smoke size.

    python3 kernel_times.py [--root DIR]

Imports `gaussian_splatting_web_tpu_torch` from DIR (default: the checkout
holding this script), so one call on one card can time two commits: unpack
the other one with `git archive` into a directory `.gitignore` lists and
pass that directory. The frame is chip_smoke.py's: the 1M-splat SH-3
`make_scene` at 1920x1080 from the bench camera, default `RenderConfig`.

"kernel" is the launch alone, with the wrapper's checks and allocations
outside the window: through `prepare_fwd`/`prepare_bwd` where the
checkout's wrapper has them, else by replaying the ctypes call its wrapper
made (the wrapper's outputs are held, so the replay writes into live
buffers). CUDA events span 5 back-to-back launches, median of 7 samples.
"wrapper" is the whole wrapper call, median of 7. Prints the card line
and one JSON line {"root": ..., "A": {"kernel_ms", "wrapper_ms"}, "B":
{...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

W, H = 1920, 1080


def median_ms(fn, runs=7, warmup=2, repeat=1):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeat):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / repeat)
    return statistics.median(times)


def replay(raster_cuda, name, call):
    """Runs `call` (a wrapper call that launches the ctypes entry point
    `name` once) → (its result, a callable that repeats that launch)."""
    made = []
    real = raster_cuda._kernel_fn

    def kernel_fn(kname, *shape):
        fn, err_str = real(kname, *shape)
        if kname != name:
            return fn, err_str

        def record(*args):
            made.append((fn, args))
            return fn(*args)
        return record, err_str

    raster_cuda._kernel_fn = kernel_fn
    try:
        out = call()
    finally:
        raster_cuda._kernel_fn = real
    if len(made) != 1:
        raise RuntimeError(f"{name}: the wrapper launched {len(made)} times")
    fn, args = made[0]

    def again():
        if fn(*args) != 0:
            raise RuntimeError(f"{name}: the replayed launch failed")
    return out, again


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    root = os.path.abspath(ap.parse_args().root)
    if not torch.cuda.is_available():
        sys.exit("kernel_times: needs a CUDA GPU")
    sys.path.insert(0, root)
    from gaussian_splatting_web_tpu_torch.bench_lib import make_scene
    from gaussian_splatting_web_tpu_torch.config import RenderConfig
    from gaussian_splatting_web_tpu_torch.core.camera import default_camera
    from gaussian_splatting_web_tpu_torch.ops.cuda import raster as rc
    from gaussian_splatting_web_tpu_torch.ops.projection import (
        project_gaussians,
    )
    from gaussian_splatting_web_tpu_torch.ops.rasterize import (
        pack_splat_fields,
    )
    from gaussian_splatting_web_tpu_torch.ops.sort import bin_splats
    if not rc.__file__.startswith(root):
        sys.exit(f"kernel_times: imported {rc.__file__}, not from {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    cfg = RenderConfig()
    with torch.no_grad():
        cloud = make_scene(1_000_000, seed=0, sh_degree=3, device=dev)
        camera = default_camera(W, H, eye=(0, 0, -8),
                                center=(0, 0, 0)).to(dev)
        splats = project_gaussians(cloud, camera, W, H, cfg)
        bins = bin_splats(splats, W, H, cfg)
        fields = pack_splat_fields(splats)
        gen = torch.Generator(device=dev).manual_seed(0)
        d_rgb = torch.randn((H, W, 3), generator=gen, device=dev)
        d_alpha = torch.randn((H, W), generator=gen, device=dev)

        def fwd():
            return rc.composite_image(fields, bins, W, H, cfg)

        def bwd():
            return rc.composite_backward(fields, bins, W, H, cfg, comp,
                                         d_rgb, d_alpha)

        if hasattr(rc, "prepare_fwd"):
            how = "prepare_*"
            comp = fwd()
            run_a = rc.prepare_fwd(fields, bins, W, H, cfg)[0]
            run_b = rc.prepare_bwd(fields, bins, W, H, cfg, comp, d_rgb,
                                   d_alpha)[0]
        else:
            how = "replayed ctypes call"
            comp, run_a = replay(rc, "raster_fwd", fwd)
            dpairs, run_b = replay(rc, "raster_bwd", bwd)   # held for B
        result = {"root": root, "kernel_timing": how}
        for name, run, wrapper in (("A", run_a, fwd), ("B", run_b, bwd)):
            result[name] = {"kernel_ms": median_ms(run, repeat=5),
                            "wrapper_ms": median_ms(wrapper)}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
