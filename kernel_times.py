#!/usr/bin/env python3
"""Kernels A-D (and E, P) of a checkout, each timed alone.

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
equal bits).

Where the checkout has them (`ops/cuda/project.py`), the projection's
kernels P fwd and P bwd are timed alone the same way (`prepare_fwd` /
`prepare_bwd`, 5 launches a sample, median of 7) on the benchmark's two
scene sizes at SH degree 3: 2.96M Gaussians at 1237x822 and 1.66M at
979x546, `make_scene`'s distribution, seen from (0, 0, -8); the backward
with random gradients of mean2d, conic, rgb and opacity (none of depth, as
in training). Each time is set against its byte floor at 3.35 TB/s:
`bench_lib.P_FWD_BYTES` (281) and `P_BWD_BYTES` (508) a Gaussian, each
input byte read once and each output byte written once; "twin_ms" is the plain twin on the card on the
same tensors (`project_gaussians_plain`, `project_backward_plain`), median
of 7. Imports nothing of JAX.

Binning (`ops/sort.py::bin_splats`) is timed whole, CUDA events around
one call, median of 7, at `mipnerf360`'s 2.96M Gaussians at 1237x822,
`tandt`'s 1.66M at 979x546 and 1M at 1920x1080 (the default exact key,
`make_scene`'s SH-0 distribution from (0, 0, -8)): "ms" is `bin_splats`,
which runs the CUDA kernels of `csrc/bin.cu` where the checkout has them,
and, where it has them, "plain_ms" is `bin_splats_plain` (the PyTorch
path) on the same tensors, whose bins must equal the kernels' bit for bit;
`launches` is `ops/cuda/bin.py`'s count over one call.
Each time is set against `bench_lib.binning_bytes` at 3.35 TB/s.
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
P_SCENES = ((2_960_000, 1237, 822), (1_660_000, 979, 546))
BIN_SCENES = (*P_SCENES, (1_000_000, W, H))


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
        result.update(projection_times(root, make_scene, default_camera))
        result.update(binning_times(make_scene, default_camera))
    print(json.dumps(result))


def binning_times(make_scene, default_camera) -> dict:
    """`bin_splats` alone at BIN_SCENES, beside the PyTorch path on the
    same tensors where the checkout has it (kernels and path equal bit for
    bit), against the byte floor."""
    from gaussian_splatting_web_tpu_torch import bench_lib
    from gaussian_splatting_web_tpu_torch.config import RenderConfig
    from gaussian_splatting_web_tpu_torch.ops import sort
    from gaussian_splatting_web_tpu_torch.ops.projection import (
        project_gaussians,
    )

    plain = getattr(sort, "bin_splats_plain", None)
    try:
        from gaussian_splatting_web_tpu_torch.ops.cuda import bin as bc
    except ImportError:
        bc = None
    fields = ("sorted_gidx", "sorted_slot", "tile_start", "tile_count",
              "num_pairs", "overflow")
    out = {}
    dev = torch.device("cuda")
    cfg = RenderConfig()
    for n, w, h in BIN_SCENES:
        cloud = make_scene(n, seed=0, sh_degree=0, device=dev)
        camera = default_camera(w, h, eye=(0, 0, -8),
                                center=(0, 0, 0)).to(dev)
        splats = project_gaussians(cloud, camera, w, h, cfg)
        before = bc.launches if bc else 0
        got = sort.bin_splats(splats, w, h, cfg)
        row = {"launches": (bc.launches - before) if bc else None}
        if plain is not None:
            want = plain(splats, w, h, cfg)
            row["equal"] = all(torch.equal(getattr(got, f), getattr(want, f))
                               for f in fields)
            row["plain_ms"] = median_ms(lambda: plain(splats, w, h, cfg))
        ms = median_ms(lambda: sort.bin_splats(splats, w, h, cfg))
        gx, gy = cfg.grid_size(w, h)
        kept = int(got.num_pairs)
        slots = got.sorted_slot.shape[0]
        row.update(ms=ms, live_pairs=kept, slots=slots)
        if hasattr(bench_lib, "binning_bytes"):
            nbytes = bench_lib.binning_bytes(n, slots, kept, gx * gy)
            floor_ms = 1e3 * nbytes / bench_lib.HBM_BYTES_S
            row.update(bytes=nbytes, floor_ms=floor_ms,
                       floor_pct=100 * floor_ms / ms)
        out[f"binning {n / 1e6:.2f}M {w}x{h}"] = row
        del cloud, splats, got
    return out


def projection_times(root, make_scene, default_camera) -> dict:
    """P fwd and P bwd alone at P_SCENES, with their byte floors; empty
    for a checkout without them."""
    try:
        from gaussian_splatting_web_tpu_torch.ops.cuda import project as pc
    except ImportError:
        return {}
    from gaussian_splatting_web_tpu_torch.bench_lib import (
        HBM_BYTES_S,
        P_BWD_BYTES,
        P_FWD_BYTES,
    )
    from gaussian_splatting_web_tpu_torch.config import RenderConfig
    from gaussian_splatting_web_tpu_torch.ops.projection import (
        pack_camera,
        project_backward_plain,
        project_gaussians_plain,
    )

    out = {}
    dev = torch.device("cuda")
    cfg = RenderConfig()
    for n, w, h in P_SCENES:
        cloud = make_scene(n, seed=0, sh_degree=3, device=dev)
        camera = default_camera(w, h, eye=(0, 0, -8),
                                center=(0, 0, 0)).to(dev)
        ins = pc._inputs(cloud.xyz, cloud.log_scale, cloud.quat,
                         cloud.opacity_logit, cloud.sh)
        cam = pack_camera(camera)
        run_f, splats = pc.prepare_fwd(ins, cam, w, h, cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        grads = [torch.randn(getattr(splats, f).shape, generator=gen,
                             device=dev) if f != "depth" else None
                 for f in ("mean2d", "conic", "depth", "rgb", "opacity")]
        run_b, _ = pc.prepare_bwd(ins, cam, grads, w, h, cfg)
        twins = (lambda: project_gaussians_plain(cloud, camera, w, h, cfg),
                 lambda: project_backward_plain(*ins, cam, w, h, cfg,
                                                *grads))
        for name, run, twin, per in (("P fwd", run_f, twins[0], P_FWD_BYTES),
                                     ("P bwd", run_b, twins[1],
                                      P_BWD_BYTES)):
            ms = median_ms(run, repeat=5)
            floor_ms = 1e3 * n * per / HBM_BYTES_S
            out[f"{name} {n / 1e6:.2f}M"] = {
                "kernel_ms": ms, "floor_ms": floor_ms,
                "floor_pct": 100.0 * floor_ms / ms, "bytes_per_gaussian": per,
                "twin_ms": median_ms(twin)}
        del cloud, ins, splats, grads, run_f, run_b, twins
    return out


if __name__ == "__main__":
    main()
