#!/usr/bin/env python3
"""Kernels A-D (and E) of a checkout, each timed alone, at the smoke size.

    python3 kernel_times.py [--root DIR]

Imports `gaussian_splatting_web_tpu_torch` from DIR (default: the checkout
holding this script), so one call on one card can time two commits: unpack
the other one with `git archive` into a directory `.gitignore` lists and
pass that directory. The frame is chip_smoke.py's: the 1M-splat SH-3
`make_scene` at 1920x1080 from the bench camera, default `RenderConfig`
for A and B and `RenderConfig(binning="anchor")` for C and D.

"kernel" is the launch alone, with the wrapper's checks and allocations
outside the window, through the wrappers' `prepare_fwd`/`prepare_bwd`
(every commit from the one that redesigned A and B has them): CUDA events
span 5 back-to-back launches, median of 7 samples. "wrapper" is the whole
wrapper call, median of 7. Where the checkout has them (`prepare_fwd_tiles`
/ `prepare_bwd_tiles`), A's and B's tile-list entries E-A and E-B are
timed the same way over one shard's list: shard 0 of 4 of the tile deal
`_padded_tile_ids(8160, 4, 32)`, padding turned into the empty sentinel.
Prints the card line and one JSON line {"root": ..., "A": {"kernel_ms",
"wrapper_ms", "sha256"}, "B": ..., "C": ..., "D": ..., "E-A": ...,
"E-B": ...}, "sha256" a digest of the wrapper's outputs (equal digests:
equal bits). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
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


def digest(out, h=None) -> str:
    """SHA-256 of a wrapper's outputs (a tensor or nested tuples of them),
    so two checkouts' outputs can be compared bit for bit."""
    h = h or hashlib.sha256()
    if isinstance(out, torch.Tensor):
        h.update(out.detach().contiguous().cpu().numpy().tobytes())
    else:
        for t in out:
            digest(t, h)
    return h.hexdigest()[:16]


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
    from gaussian_splatting_web_tpu_torch.ops.anchor import bin_splats_anchor
    from gaussian_splatting_web_tpu_torch.ops.cuda import anchor as ac
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
    cfg_a = RenderConfig(binning="anchor")
    with torch.no_grad():
        cloud = make_scene(1_000_000, seed=0, sh_degree=3, device=dev)
        camera = default_camera(W, H, eye=(0, 0, -8),
                                center=(0, 0, 0)).to(dev)
        splats = project_gaussians(cloud, camera, W, H, cfg)
        bins = bin_splats(splats, W, H, cfg)
        abins = bin_splats_anchor(splats, W, H, cfg_a)
        fields = pack_splat_fields(splats)
        gen = torch.Generator(device=dev).manual_seed(0)
        d_rgb = torch.randn((H, W, 3), generator=gen, device=dev)
        d_alpha = torch.randn((H, W), generator=gen, device=dev)
        comp = rc.composite_image(fields, bins, W, H, cfg)
        comp_a, merge = ac.composite_anchor(fields, abins, W, H, cfg_a)
        wrappers = {
            "A": lambda: rc.composite_image(fields, bins, W, H, cfg),
            "B": lambda: rc.composite_backward(fields, bins, W, H, cfg, comp,
                                               d_rgb, d_alpha),
            "C": lambda: ac.composite_anchor(fields, abins, W, H, cfg_a),
            "D": lambda: ac.composite_anchor_backward(
                fields, abins, W, H, cfg_a, comp_a, merge, d_rgb, d_alpha),
        }
        runs = {
            "A": rc.prepare_fwd(fields, bins, W, H, cfg)[0],
            "B": rc.prepare_bwd(fields, bins, W, H, cfg, comp, d_rgb,
                                d_alpha)[0],
            "C": ac.prepare_fwd(fields, abins, W, H, cfg_a)[0],
            "D": ac.prepare_bwd(fields, abins, W, H, cfg_a, comp_a, merge,
                                d_rgb, d_alpha)[0],
        }
        if hasattr(rc, "prepare_fwd_tiles"):
            from gaussian_splatting_web_tpu_torch.parallel.render_sharded \
                import shard_tile_ids
            ids = shard_tile_ids(cfg.num_tiles(W, H), 4, 32, 0).to(dev)
            out = rc.composite_tiles_list(fields, bins, ids, W, H, cfg)
            d_rgba = torch.randn((ids.shape[0], 256, 4), generator=gen,
                                 device=dev)
            wrappers["E-A"] = lambda: rc.composite_tiles_list(
                fields, bins, ids, W, H, cfg)
            wrappers["E-B"] = lambda: rc.composite_tiles_backward(
                fields, bins, ids, W, H, cfg, out.final_log_t, out.last_idx,
                d_rgba)
            runs["E-A"] = rc.prepare_fwd_tiles(fields, bins, ids, W, H,
                                               cfg)[0]
            runs["E-B"] = rc.prepare_bwd_tiles(
                fields, bins, ids, W, H, cfg, out.final_log_t, out.last_idx,
                d_rgba)[0]
        result = {"root": root}
        for name, run in runs.items():
            result[name] = {"kernel_ms": median_ms(run, repeat=5),
                            "wrapper_ms": median_ms(wrappers[name]),
                            "sha256": digest(wrappers[name]())}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
