#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's render path (project → bin → kernel A → post-process)
and its training path (render → kernel B → fold → L1 + D-SSIM → Adam →
densify) through the entry points a user calls, at the repo's benchmark
size: the 1M-splat SH-degree-3 `make_scene(1_000_000)` at 1920x1080 from
the bench camera (eye (0, 0, -8) looking at the origin). Phases, each
printing one line; any failure raises and exits non-zero:

  0 device   nvidia-smi name and power limit; a CUDA device is required
  1 build    nvcc builds csrc/raster_fwd.cu and csrc/raster_bwd.cu, one
             process each, started together
  2 kernel   kernel A vs its plain PyTorch twin on the same bins: an
             opaque early-exit scene, a 72x40 ragged frame, a 96x64
             adversarial scene (`bench_lib.make_adversarial_scene`:
             needles, centres off the frame, opacities at the cutoff,
             sub-pixel splats, splats past max_dup) and the full 1080p
             frame; on each, the footprint cull's plain mirror against
             the twin's power (no culled step may pass the cutoff; the
             culled share is printed); A timed at 1080p alone and
             through its wrapper
  3 bwd      kernel B vs its plain twin on the same four scenes, after
             the fold (the gradient-parity gate below), bitwise
             repeatable on each; B alone, B through its wrapper, its twin
             and the fold timed at 1080p
  4 render   `render` for a few frames: one kernel A launch per frame, a
             finite non-black image, pair and shrink counts against the
             JAX package's CPU figures; per-stage medians
  5 step     forward + backward through `render` at 1080p: A and B once
             per step, finite parameter gradients; median step time
  6 serve    `ViewerApp` at 1280x720 answers init/rotate/zoom/pan/tick
             with RGBA frames that encode to PNG
  7 cli      `cli render --device cuda` on a 100k-splat PLY writes a PNG
  8 train    `train()` from make_scene(1M, seed 0) on four 1920x1080 views
             that `render` made of make_scene(1M, seed 1): 30 iterations,
             one forced densify round, SH bands unlocked on the way; A and
             B once per iteration, finite losses whose last five average
             below the first five, a changed alive count; ms/iteration
  9 cli      `cli train --device cuda` on a small synthetic capture (PNGs
             and cameras.json written here) writes a PLY `read_ply` loads

The anchor-binning path (`RenderConfig(binning="anchor")`, kernels C and D,
default caps: 1,536-position covers, k_cap 1024):

 10 anchor   kernel C vs its plain twin on the same anchor bins: the opaque,
             ragged and adversarial scenes, a crowded 64x48 scene whose
             ranges overrun their cover and whose tiles hold more than
             k_cap candidates, and 1080p; identical ordered lists, the
             image rule; C alone, through its wrapper and its twin timed at
             1080p
 11 anchor   kernel D vs its plain twin after the fold on the same scenes
             (the gradient rule), bitwise repeatable; D alone, through its
             wrapper, its twin and the fold timed at 1080p
 12 anchor   `render` at 1080p for a few frames: one C launch per frame, no
             A or B; entries, overflow and truncated ranges against the JAX
             package's CPU figures; per-stage medians; the share of pixels
             off the dup path's frame by more than 2e-4 (printed, not gated)
 13 anchor   fwd+bwd through `render` at 1080p, C and D once per step,
             finite parameter gradients; `ViewerApp` answers two events
 14 anchor   `train()` as phase 8 with binning='anchor': C and D once per
             iteration, finite losses that fall; ms/iteration

Image rule (tests/conftest.py::assert_images_close): at most 2e-4 of the
pixels may differ by more than 2e-4; on the pixels that agree, the
residual log-transmittance agrees to 1e-4. Gradient rule
(bench_lib.grad_parity_ok): over the folded [N, 9] gradients, p99 of
|kernel − twin| / max|twin| per column ≤ 1e-3, and at most 1e-5 of the
elements plus 2 off by more than 1%. TF32 is switched off for matmuls and
cuDNN so the plain twins and SSIM compute in full f32.

Kernel times: "kernel" is the launch alone (`prepare_*` does the checks
and allocations first; CUDA events around 5 back-to-back launches, divided
by 5, median of 7 samples after warm-up; A's and B's launches include
their one-block tile-schedule kernel), the time in the JSON line;
"wrapper" is the whole wrapper call (checks, allocations, launch) between
CUDA events, median of 7; the plain twins are timed that way too. C and D
are timed with the same helpers.

Each kernel's bound is the larger of its bytes (each input read once, each
output written once) over 3.35 TB/s and the operations this run's data
needs over the card's peak: FP32 operations over 67 TFLOP/s, and exp/
log1p/reciprocal/sqrt over the special-function units (16 per SM per
clock, 132 SMs, 1.98 GHz). The operations needed are the pair-pixel steps
that pass the cutoff, each at a step's full cost, plus one footprint test
per (pair, tile) that some pixel of the tile walks to: a step that cannot
pass does no work, and the footprint test rules it out. Steps are counted
from this run's bins: kernels A and C walk each pixel up to its early
exit, B and D up to its last contributing pair; C and D count as A and B
over the ordered lists. Printed beside it, the "step bound" charges a
power evaluation to every walked step, passing or not (the definition the
port's first kernels were measured against, kept so shares compare across
records). C's bytes add its merge's union loads (5 bytes per position
read, every tile's two covers) and its ordered-list outputs; its sort's
compares are not counted as operations. D's bytes count the ordered lists
it reads and the rows it writes (36 bytes per kept pair), not the zeroed
array.

Prints the card line, a JSON line of kernel results, and last
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gaussian_splatting_web_tpu_torch.bench_lib import (
    grad_parity,
    grad_parity_ok,
    make_adversarial_scene,
    make_scene,
)
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core.camera import default_camera
from gaussian_splatting_web_tpu_torch.io.dataset import View
from gaussian_splatting_web_tpu_torch.io.ply import read_ply, write_ply
from gaussian_splatting_web_tpu_torch.models.gaussian_model import (
    PARAMS,
    GaussianModel,
)
from gaussian_splatting_web_tpu_torch.ops import anchor, rasterize
from gaussian_splatting_web_tpu_torch.ops.composite import post_process
from gaussian_splatting_web_tpu_torch.ops.cuda import anchor as anchor_cuda
from gaussian_splatting_web_tpu_torch.ops.cuda import build
from gaussian_splatting_web_tpu_torch.ops.cuda import raster as raster_cuda
from gaussian_splatting_web_tpu_torch.ops.projection import project_gaussians
from gaussian_splatting_web_tpu_torch.ops.rasterize import (
    composite_backward_plain,
    composite_image_plain,
    fold_pair_grads,
    pack_splat_fields,
    rasterize_tiles,
    render,
)
from gaussian_splatting_web_tpu_torch.ops.sort import bin_splats
from gaussian_splatting_web_tpu_torch.train.train_loop import (
    TrainLoopConfig,
    train,
)
from gaussian_splatting_web_tpu_torch.utils.image import (
    encode_png,
    read_png,
    write_png,
)
from gaussian_splatting_web_tpu_torch.viewer.server import ViewerApp

REPO = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
N_SCENE = 1_000_000
# the JAX package's exact-mode projection + binning of this scene and
# camera on the CPU: live (tile, splat) pairs and centre-shrunk splats
CPU_PAIRS, CPU_OVERFLOW = 2_150_328, 13
# the same for the anchor binning: live pairs, overflow (dup-tier tiles past
# max_dup) and (tile, range) covers the range overruns
ANCHOR_PAIRS, ANCHOR_OVERFLOW, ANCHOR_TRUNCATED = 2_150_377, 248, 264
ATOL, MAX_BAD_FRAC, LOG_T_TOL = 2e-4, 2e-4, 1e-4
GRAD_EXTRA = 2            # knife-edge outliers allowed on top of 1e-5 of n
KERNELS = {
    "raster_fwd": ("gaussian_splatting_web_tpu_torch/csrc/raster_fwd.cu",
                   "gaussian_splatting_web_tpu/ops/pallas/raster.py:219"),
    "raster_bwd": ("gaussian_splatting_web_tpu_torch/csrc/raster_bwd.cu",
                   "gaussian_splatting_web_tpu/ops/pallas/raster_bwd.py:64"),
    "anchor_fwd": ("gaussian_splatting_web_tpu_torch/csrc/anchor_fwd.cu",
                   "gaussian_splatting_web_tpu/ops/pallas/anchor.py:639"),
    "anchor_bwd": ("gaussian_splatting_web_tpu_torch/csrc/anchor_bwd.cu",
                   "gaussian_splatting_web_tpu/ops/pallas/anchor.py:928"),
}
# peaks of one H100 SXM (NVIDIA data sheet; SFU: 16 results per SM per
# clock at the 1.98 GHz boost clock)
HBM_BYTES_S, FP32_FLOPS_S, SFU_OPS_S = 3.35e12, 67e12, 132 * 16 * 1.98e9
# operations per pair-pixel step, read off the kernels' inner loops: every
# step evaluates power (5 mul + 5 add) and compares it; a step past the
# cutoff adds, in A, fmin, the log-T add and compare, w, four colour/alpha
# accumulations (12 FP32) and exp, log1p, exp (3 SFU); in B, fmin, the
# log-T subtract, w, r (3 fma), dα, the suffix, dpow, nine moment products
# and their nine reduction adds (35 FP32) and exp, log1p, exp and the
# reciprocal of 1 − α (4 SFU)
STEP_FP32 = 11
PASS_FP32 = {"raster_fwd": 12, "raster_bwd": 35, "anchor_fwd": 12,
             "anchor_bwd": 35}
PASS_SFU = {"raster_fwd": 3, "raster_bwd": 4, "anchor_fwd": 3,
            "anchor_bwd": 4}
# one footprint test (csrc/footprint.cuh): 27 mul, 22 add, 36 compares and
# 6 abs in FP32; two divisions and two square roots on the SFUs
FOOT_FP32, FOOT_SFU = 91, 4


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def launch_counts():
    """Launches of kernels A, B, C and D since the last reset."""
    return {"A": raster_cuda.launches, "B": raster_cuda.launches_bwd,
            "C": anchor_cuda.launches, "D": anchor_cuda.launches_bwd}


def reset_counts():
    raster_cuda.launches = raster_cuda.launches_bwd = 0
    anchor_cuda.launches = anchor_cuda.launches_bwd = 0


def median_ms(fn, runs, warmup=2, repeat=1):
    """Median device time of fn() in ms: CUDA events around `repeat`
    back-to-back runs, divided by `repeat`, median of `runs` samples."""
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


def kernel_ms(prepared):
    """Device time of one launch alone, in ms: `prepared` is what a
    wrapper's `prepare_*` returns, (run, outputs, ...), its checks and
    allocations done, so the window holds launches only."""
    return median_ms(prepared[0], 7, repeat=5)


def compare(got, want, what):
    """Hold kernel A's output against the plain twin by the image rule."""
    img = torch.cat([got.rgb, got.alpha[..., None]], -1)
    ref = torch.cat([want.rgb, want.alpha[..., None]], -1)
    check(bool(torch.isfinite(img).all()), f"{what}: non-finite kernel output")
    diff = (img - ref).abs().amax(-1)
    bad = diff > ATOL
    bad_frac = bad.float().mean().item()
    check(bad_frac <= MAX_BAD_FRAC,
          f"{what}: {int(bad.sum())} pixels ({bad_frac:.2e}) differ > {ATOL}")
    dlog = (got.final_log_t - want.final_log_t).abs()[~bad]
    dlog_max = dlog.max().item() if dlog.numel() else 0.0
    check(dlog_max <= LOG_T_TOL,
          f"{what}: residual log-T differs by {dlog_max:.2e}")
    last_frac = (got.last_idx != want.last_idx).float().mean().item()
    check(last_frac <= MAX_BAD_FRAC,
          f"{what}: last-contributor index differs on {last_frac:.2e}")
    return {"max_abs_err": diff.max().item(), "bad_frac": bad_frac,
            "log_t_err": dlog_max, "last_idx_frac": last_frac}


def bench_camera(w, h, dev):
    return default_camera(w, h, eye=(0, 0, -8), center=(0, 0, 0)).to(dev)


def binned(cloud, camera, w, h, cfg):
    splats = project_gaussians(cloud, camera, w, h, cfg)
    bins = bin_splats(splats, w, h, cfg)
    return pack_splat_fields(splats), bins


def small_scenes(dev):
    """An opaque stack (every central pixel exits early), a ragged 72x40
    frame and the adversarial scene of the footprint cull: (name, cloud,
    width, height, eye z)."""
    rng = np.random.default_rng(7)
    n = 40
    opaque = make_scene(n, seed=5, sh_degree=0, device=dev)
    opaque.xyz = torch.from_numpy(np.concatenate(
        [rng.normal(scale=0.05, size=(n, 2)), rng.uniform(-2, 2, (n, 1))],
        axis=1).astype(np.float32)).to(dev)
    opaque.opacity_logit = torch.full((n,), 6.0, device=dev)
    opaque.log_scale = torch.full((n, 3), -0.7, device=dev)
    small = make_scene(2000, seed=3, sh_degree=3, device=dev)
    return [("opaque 48x48", opaque, 48, 48, -6.0),
            ("ragged 72x40", small, 72, 40, -8.0),
            ("adversarial 96x64", make_adversarial_scene(device=dev), 96, 64,
             -6.0)]


def work(fields, bins, comp, w, h, cfg):
    """Pair-pixel steps of this frame, for A and B: `steps` walked, of
    which `passed` pass the cutoff, and the (pair, tile)s some pixel of
    the tile walks to, `pairs`. A walks each pixel up to and including its
    early-exit pair (the whole segment if it never saturates); B walks
    each pixel up to its last contributing pair."""
    gx, gy = cfg.grid_size(w, h)
    ts = cfg.tile_size
    dev = fields.device
    tile_ids = torch.arange(gx * gy, device=dev)
    inside = rasterize.tile_major(torch.ones((h, w, 1), device=dev), gx, gy,
                                  ts)[..., 0] > 0                 # [T, P]
    last = rasterize.tile_major(comp.last_idx[..., None], gx, gy, ts,
                                fill=-1)[..., 0]
    log_eps = math.log(cfg.transmittance_eps)
    totals = torch.zeros(6, dtype=torch.float64, device=dev)
    starts, counts, spans = rasterize._chunks(bins, tile_ids, cfg)
    with torch.no_grad():
        for sl, k_len in spans:
            seg = rasterize._segments(fields, bins, tile_ids, starts, counts,
                                      sl, k_len, gx, cfg)
            live = seg.live[..., None] & inside[sl][:, None, :]
            passed = seg.alpha > 0
            incl = torch.cumsum(torch.log1p(-seg.alpha), dim=1)
            # steps up to the first violator, inclusive
            walked = torch.cumsum((incl < log_eps).to(torch.int32), 1)
            walked = (walked - (incl < log_eps).to(torch.int32)) == 0
            k = torch.arange(k_len, device=dev)
            to_last = k[None, :, None] <= last[sl][:, None, :]
            a = live & walked
            b = live & to_last
            totals += torch.stack([
                a.sum(), (a & passed).sum(), a.any(-1).sum(), b.sum(),
                (b & passed).sum(), b.any(-1).sum()]).double()
    v = [int(x) for x in totals.tolist()]
    return {"A": dict(steps=v[0], passed=v[1], pairs=v[2]),
            "B": dict(steps=v[3], passed=v[4], pairs=v[5])}


def bound(name, w, nbytes):
    """(bound_ms, bound_by, step_bound_ms) for the work `w` (one kernel's
    entry of `work`) and `nbytes`: the bound counts the passing steps at
    full cost and one footprint test per pair; the step bound counts a
    power evaluation at every walked step."""
    flops = (w["passed"] * (STEP_FP32 + PASS_FP32[name])
             + w["pairs"] * FOOT_FP32)
    sfu = w["passed"] * PASS_SFU[name] + w["pairs"] * FOOT_SFU
    ops_s = max(flops / FP32_FLOPS_S, sfu / SFU_OPS_S)
    bytes_s = nbytes / HBM_BYTES_S
    step_flops = w["steps"] * STEP_FP32 + w["passed"] * PASS_FP32[name]
    step_s = max(step_flops / FP32_FLOPS_S,
                 w["passed"] * PASS_SFU[name] / SFU_OPS_S, bytes_s)
    return (max(ops_s, bytes_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations", step_s * 1e3)


def work_line(w, nbytes, bound_ms, bound_by, step_ms, passing="past the "
              "cutoff"):
    return (f"pair-pixel steps {w['steps']} ({w['passed']} {passing}), "
            f"(pair, tile)s walked {w['pairs']}, {nbytes} bytes: bound "
            f"{bound_ms:.4f} ms by {bound_by}, step bound {step_ms:.4f} ms")


def phase_device():
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "run needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"[0 device] {torch.cuda.get_device_name(0)}, "
          f"count={torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, python {sys.version.split()[0]}")
    return torch.device("cuda")


def phase_build():
    t0 = time.perf_counter()
    build.load_all(KERNELS)
    dt = time.perf_counter() - t0
    parts = []
    for name in KERNELS:
        log = build.build_logs.get(name)
        ptxas = " ".join(ln.split("ptxas info    :")[-1].strip()
                         for ln in (log or "").splitlines()
                         if "registers" in ln)
        how = "built" if log is not None else "loaded (cached build)"
        parts.append(f"{name}.cu {how}; ptxas: {ptxas or 'n/a'}")
    print(f"[1 build] {dt:.2f} s, one nvcc per source in parallel: "
          + "; ".join(parts))


def cull_check(fields, bins, w, h, cfg, what):
    """The footprint cull's plain mirror against the twin's power: no
    culled step passes the cutoff → the culled share of the live steps."""
    stats = raster_cuda.cull_stats(fields, bins, w, h, cfg)
    check(stats["missed"] == 0, f"{what}: the cull skips {stats['missed']} "
          "steps whose power passes the cutoff")
    return stats["culled"] / max(stats["steps"], 1)


def phase_kernel(dev, cloud, cfg):
    findings = {}
    for what, scene, w, h, z in small_scenes(dev):
        camera = default_camera(w, h, eye=(0, 0, z), center=(0, 0, 0)).to(dev)
        fields, bins = binned(scene, camera, w, h, cfg)
        got = raster_cuda.composite_image(fields, bins, w, h, cfg)
        want = composite_image_plain(fields, bins, w, h, cfg)
        findings[what] = compare(got, want, what)
        findings[what]["culled"] = cull_check(fields, bins, w, h, cfg, what)
        if what.startswith("opaque"):
            check(bool((got.alpha > 0.999).any()), "opaque scene: no pixel "
                  "saturated, the early exit was not exercised")
        if what.startswith("adversarial"):
            check(int(bins.overflow) > 0, "adversarial scene: no splat "
                  "reached max_dup")

    camera = bench_camera(W, H, dev)
    fields, bins = binned(cloud, camera, W, H, cfg)
    got = raster_cuda.composite_image(fields, bins, W, H, cfg)
    want = composite_image_plain(fields, bins, W, H, cfg)
    full = compare(got, want, "1080p")
    full["culled"] = cull_check(fields, bins, W, H, cfg, "1080p")
    ms = kernel_ms(raster_cuda.prepare_fwd(fields, bins, W, H, cfg))
    wrapper_ms = median_ms(
        lambda: raster_cuda.composite_image(fields, bins, W, H, cfg), 7)
    plain_ms = median_ms(
        lambda: composite_image_plain(fields, bins, W, H, cfg), 7, warmup=1)
    findings["1080p"] = full
    steps = work(fields, bins, got, W, H, cfg)
    t = cfg.num_tiles(W, H)
    nbytes = (fields.numel() * 4 + bins.sorted_gidx.numel() * 4 + t * 8
              + H * W * 6 * 4)
    bound_ms, bound_by, step_ms = bound("raster_fwd", steps["A"], nbytes)
    print(f"[2 kernel] kernel A vs plain twin: "
          + "; ".join(f"{k}: max_abs_err {v['max_abs_err']:.3e}, "
                      f">{ATOL} on {v['bad_frac']:.2e}, "
                      f"log-T err {v['log_t_err']:.2e}, "
                      f"last-idx diff {v['last_idx_frac']:.2e}, "
                      f"culled {v['culled']:.4f} of the steps, 0 passing"
                      for k, v in findings.items())
          + f"; 1080p kernel {ms:.3f} ms, wrapper {wrapper_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms; "
          + work_line(steps["A"], nbytes, bound_ms, bound_by, step_ms))
    return {"max_abs_err": full["max_abs_err"], "ms": ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}, (fields, bins, got, steps)


def backward_vs_plain(fields, bins, fwd, w, h, cfg, what):
    """Kernel B against its plain twin after the fold (the gradient
    rule), and B run twice on the same inputs gives the same bits."""
    gen = torch.Generator(device=fields.device).manual_seed(0)
    d_rgb = torch.randn((h, w, 3), generator=gen, device=fields.device)
    d_alpha = torch.randn((h, w), generator=gen, device=fields.device)
    got = raster_cuda.composite_backward(fields, bins, w, h, cfg, fwd,
                                         d_rgb, d_alpha)
    again = raster_cuda.composite_backward(fields, bins, w, h, cfg, fwd,
                                           d_rgb, d_alpha)
    check(torch.equal(got, again), f"{what}: kernel B is not deterministic")
    want = composite_backward_plain(fields, bins, w, h, cfg, fwd, d_rgb,
                                    d_alpha)
    n = fields.shape[0]
    g_got = fold_pair_grads(got, bins, n)
    g_want = fold_pair_grads(want, bins, n)
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite B output")
    check(g_want.abs().max().item() > 0, f"{what}: zero gradients")
    stats = grad_parity(g_got.T, g_want.T)
    stats["max_abs_err"] = (g_got - g_want).abs().max().item()
    check(grad_parity_ok(stats, GRAD_EXTRA),
          f"{what}: kernel B vs twin outside the gradient rule: {stats}")
    return stats, (d_rgb, d_alpha, got)


def phase_backward(dev, cfg, full):
    findings = {}
    for what, scene, w, h, z in small_scenes(dev):
        camera = default_camera(w, h, eye=(0, 0, z), center=(0, 0, 0)).to(dev)
        fields, bins = binned(scene, camera, w, h, cfg)
        fwd = raster_cuda.composite_image(fields, bins, w, h, cfg)
        findings[what], _ = backward_vs_plain(fields, bins, fwd, w, h, cfg,
                                              what)
    fields, bins, fwd, steps = full
    stats, (d_rgb, d_alpha, dpairs) = backward_vs_plain(
        fields, bins, fwd, W, H, cfg, "1080p")
    findings["1080p"] = stats
    ms = kernel_ms(raster_cuda.prepare_bwd(fields, bins, W, H, cfg, fwd,
                                           d_rgb, d_alpha))
    wrapper_ms = median_ms(lambda: raster_cuda.composite_backward(
        fields, bins, W, H, cfg, fwd, d_rgb, d_alpha), 7)
    plain_ms = median_ms(lambda: composite_backward_plain(
        fields, bins, W, H, cfg, fwd, d_rgb, d_alpha), 7, warmup=1)
    n = fields.shape[0]
    fold_ms = median_ms(lambda: fold_pair_grads(dpairs, bins, n), 7)
    t = cfg.num_tiles(W, H)
    nbytes = (fields.numel() * 4 + bins.sorted_gidx.numel() * 4 + t * 8
              + H * W * 6 * 4 + dpairs.numel() * 4)
    bound_ms, bound_by, step_ms = bound("raster_bwd", steps["B"], nbytes)
    print("[3 bwd] kernel B vs plain twin after the fold, bitwise "
          "repeatable on each scene: "
          + "; ".join(f"{k}: p99 {v['p99']:.2e}, max {v['max']:.2e}, "
                      f">1% {v['nbig']}/{v['n']}, "
                      f"max_abs_err {v['max_abs_err']:.3e}"
                      for k, v in findings.items())
          + f"; 1080p kernel {ms:.3f} ms, wrapper {wrapper_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, fold {fold_ms:.3f} ms; "
          + work_line(steps["B"], nbytes, bound_ms, bound_by, step_ms,
                      "contributing"))
    return {"max_abs_err": findings["1080p"]["max_abs_err"], "ms": ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "fold_ms": fold_ms}


def crowded_scene(dev):
    """2500 small splats over the central tiles of a 64x48 frame: at the
    default caps some ranges overrun their 1,536-position cover and some
    tiles hold more than k_cap = 1024 touched candidates."""
    cloud = make_scene(2500, seed=9, sh_degree=0,
                       log_scale_range=(-3.5, -1.5), device=dev)
    cloud.xyz = cloud.xyz * 0.15
    return ("crowded 64x48", cloud, 64, 48, -6.0)


def anchor_binned(cloud, camera, w, h, cfg):
    splats = project_gaussians(cloud, camera, w, h, cfg)
    return pack_splat_fields(splats), anchor.bin_splats_anchor(splats, w, h,
                                                                cfg)


def anchor_vs_plain(fields, abins, w, h, cfg, what):
    """Kernel C against its plain twin: identical ordered lists, lengths
    and row groups, and the image rule."""
    got, merge = anchor_cuda.composite_anchor(fields, abins, w, h, cfg)
    want, want_merge = anchor.composite_anchor_plain(fields, abins, w, h,
                                                     cfg)
    for name, a, b in zip(anchor.Merge._fields, merge, want_merge):
        check(torch.equal(a, b), f"{what}: kernel C's {name} differs from "
              "the plain merge")
    return compare(got, want, what), got, merge


def phase_anchor_kernel(dev, cloud, cfg):
    findings = {}
    half = anchor.c_max(cfg) * anchor.KCL
    kc = anchor.k_cap(cfg)
    for what, scene, w, h, z in small_scenes(dev) + [crowded_scene(dev)]:
        camera = default_camera(w, h, eye=(0, 0, z), center=(0, 0, 0)).to(dev)
        fields, abins = anchor_binned(scene, camera, w, h, cfg)
        findings[what], got, merge = anchor_vs_plain(fields, abins, w, h, cfg,
                                                     what)
        if what.startswith("crowded"):
            rng = anchor.tile_ranges(abins, *cfg.grid_size(w, h), cfg)
            check(int((rng.s1 - rng.base).max()) > half and
                  int(merge.k_used.max()) == kc,
                  "crowded scene: no cover overrun or no k_cap cut")

    camera = bench_camera(W, H, dev)
    fields, abins = anchor_binned(cloud, camera, W, H, cfg)
    findings["1080p"], got, merge = anchor_vs_plain(fields, abins, W, H, cfg,
                                                    "1080p")
    ms = kernel_ms(anchor_cuda.prepare_fwd(fields, abins, W, H, cfg))
    wrapper_ms = median_ms(
        lambda: anchor_cuda.composite_anchor(fields, abins, W, H, cfg), 7)
    plain_ms = median_ms(
        lambda: anchor.composite_anchor_plain(fields, abins, W, H, cfg), 7,
        warmup=1)
    view, vcfg = anchor.ordered_view(abins, merge, cfg)
    steps = work(fields, view, got, W, H, vcfg)
    gx, gy = cfg.grid_size(W, H)
    t = gx * gy
    rng = anchor.tile_ranges(abins, gx, gy, cfg)
    union = int(torch.clamp(torch.minimum(rng.s1, rng.base + half) - rng.s0,
                            min=0).sum())
    kept = int(merge.k_used.sum())
    nbytes = (fields.numel() * 4 + (t + 1) * 4 + union * 5 + kept * 4
              + H * W * 6 * 4 + t * kc * 5 + t * 4)
    bound_ms, bound_by, step_ms = bound("anchor_fwd", steps["A"], nbytes)
    print(f"[10 anchor] kernel C vs plain twin: "
          + "; ".join(f"{k}: max_abs_err {v['max_abs_err']:.3e}, "
                      f">{ATOL} on {v['bad_frac']:.2e}, "
                      f"log-T err {v['log_t_err']:.2e}, "
                      f"last-idx diff {v['last_idx_frac']:.2e}"
                      for k, v in findings.items())
          + f"; ordered lists identical; 1080p kernel {ms:.3f} ms, wrapper "
          f"{wrapper_ms:.3f} ms, plain {plain_ms:.3f} ms; union positions "
          f"read {union}, kept pairs {kept}; "
          + work_line(steps["A"], nbytes, bound_ms, bound_by, step_ms))
    return {"max_abs_err": findings["1080p"]["max_abs_err"], "ms": ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}, (fields, abins, got, merge, steps)


def anchor_backward_vs_plain(fields, abins, fwd, merge, w, h, cfg, what):
    """Kernel D against its plain twin after the fold (the gradient rule),
    and D run twice on the same inputs gives the same bits."""
    gen = torch.Generator(device=fields.device).manual_seed(0)
    d_rgb = torch.randn((h, w, 3), generator=gen, device=fields.device)
    d_alpha = torch.randn((h, w), generator=gen, device=fields.device)
    got = anchor_cuda.composite_anchor_backward(fields, abins, w, h, cfg, fwd,
                                                merge, d_rgb, d_alpha)
    again = anchor_cuda.composite_anchor_backward(fields, abins, w, h, cfg,
                                                  fwd, merge, d_rgb, d_alpha)
    check(torch.equal(got, again), f"{what}: kernel D is not deterministic")
    want = anchor.composite_anchor_backward_plain(fields, abins, w, h, cfg,
                                                  fwd, d_rgb, d_alpha)
    n = fields.shape[0]
    g_got = anchor.fold_anchor_grads(got, abins, n)
    g_want = anchor.fold_anchor_grads(want, abins, n)
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite D output")
    check(g_want.abs().max().item() > 0, f"{what}: zero gradients")
    stats = grad_parity(g_got.T, g_want.T)
    stats["max_abs_err"] = (g_got - g_want).abs().max().item()
    check(grad_parity_ok(stats, GRAD_EXTRA),
          f"{what}: kernel D vs twin outside the gradient rule: {stats}")
    return stats, (d_rgb, d_alpha, got)


def phase_anchor_backward(dev, cfg, full):
    findings = {}
    for what, scene, w, h, z in small_scenes(dev) + [crowded_scene(dev)]:
        camera = default_camera(w, h, eye=(0, 0, z), center=(0, 0, 0)).to(dev)
        fields, abins = anchor_binned(scene, camera, w, h, cfg)
        fwd, merge = anchor_cuda.composite_anchor(fields, abins, w, h, cfg)
        findings[what], _ = anchor_backward_vs_plain(fields, abins, fwd,
                                                     merge, w, h, cfg, what)
    fields, abins, fwd, merge, steps = full
    stats, (d_rgb, d_alpha, dpairs) = anchor_backward_vs_plain(
        fields, abins, fwd, merge, W, H, cfg, "1080p")
    findings["1080p"] = stats
    ms = kernel_ms(anchor_cuda.prepare_bwd(fields, abins, W, H, cfg, fwd,
                                           merge, d_rgb, d_alpha))
    wrapper_ms = median_ms(lambda: anchor_cuda.composite_anchor_backward(
        fields, abins, W, H, cfg, fwd, merge, d_rgb, d_alpha), 7)
    plain_ms = median_ms(lambda: anchor.composite_anchor_backward_plain(
        fields, abins, W, H, cfg, fwd, d_rgb, d_alpha), 7, warmup=1)
    n = fields.shape[0]
    fold_ms = median_ms(lambda: anchor.fold_anchor_grads(dpairs, abins, n), 7)
    t = cfg.num_tiles(W, H)
    kept = int(merge.k_used.sum())
    nbytes = (fields.numel() * 4 + kept * (4 + 4 + 1) + t * 4
              + H * W * 6 * 4 + kept * 36)
    bound_ms, bound_by, step_ms = bound("anchor_bwd", steps["B"], nbytes)
    print("[11 anchor] kernel D vs plain twin after the fold: "
          + "; ".join(f"{k}: p99 {v['p99']:.2e}, max {v['max']:.2e}, "
                      f">1% {v['nbig']}/{v['n']}, "
                      f"max_abs_err {v['max_abs_err']:.3e}"
                      for k, v in findings.items())
          + f"; bitwise repeatable; 1080p kernel {ms:.3f} ms, wrapper "
          f"{wrapper_ms:.3f} ms, plain {plain_ms:.3f} ms, fold "
          f"{fold_ms:.3f} ms; "
          + work_line(steps["B"], nbytes, bound_ms, bound_by, step_ms,
                      "contributing"))
    return {"max_abs_err": findings["1080p"]["max_abs_err"], "ms": ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "fold_ms": fold_ms}


def phase_render(dev, cloud, cfg, frames=5, ref=None):
    """`render` for a few frames with cfg's binning; `ref` is the dup
    path's frame to hold an anchor frame against (printed only)."""
    is_anchor = cfg.binning == "anchor"
    label, kernel = ("12 anchor", "C") if is_anchor else ("4 render", "A")
    pairs, over = ((ANCHOR_PAIRS, ANCHOR_OVERFLOW) if is_anchor
                   else (CPU_PAIRS, CPU_OVERFLOW))
    camera = bench_camera(W, H, dev)
    stages = {"projection": [], "binning": [], "composite": [], "frame": []}
    with torch.no_grad():
        for _ in range(3):           # stage split: host clock + synchronize
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            splats = project_gaussians(cloud, camera, W, H, cfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if is_anchor:
                bins = anchor.bin_splats_anchor(splats, W, H, cfg)
            else:
                bins = bin_splats(splats, W, H, cfg)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if is_anchor:
                anchor_cuda.composite_image_anchor(
                    pack_splat_fields(splats), bins, W, H, cfg)
            else:
                rasterize_tiles(splats, bins, W, H, cfg)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            stages["projection"].append((t1 - t0) * 1e3)
            stages["binning"].append((t2 - t1) * 1e3)
            stages["composite"].append((t3 - t2) * 1e3)

        reset_counts()
        for _ in range(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, aux = render(cloud, camera, W, H, cfg)
            rgba = post_process(img, aux["alpha"], cfg)
            torch.cuda.synchronize()
            stages["frame"].append((time.perf_counter() - t0) * 1e3)
        counts = launch_counts()
    check(counts == {k: frames * (k == kernel) for k in counts},
          f"render launched {counts} in {frames} frames")
    check(img.shape == (H, W, 3) and rgba.shape == (H, W, 4), "frame shape")
    check(bool(torch.isfinite(rgba).all()), "non-finite frame")
    mean = rgba[..., :3].mean().item()
    covered = (aux["alpha"] > 0.01).float().mean().item()
    check(mean > 1e-3 and covered > 0.05, f"black frame (mean {mean:.2e})")
    num_pairs = int(aux["num_pairs"])
    overflow = int(aux["overflow"])
    check(abs(num_pairs - pairs) <= 1e-3 * pairs,
          f"num_pairs {num_pairs} vs CPU {pairs}")
    check(abs(overflow - over) <= 5, f"overflow {overflow} vs CPU {over}")
    extra = ""
    if is_anchor:
        gx, gy = cfg.grid_size(W, H)
        rng = anchor.tile_ranges(bins, gx, gy, cfg)
        half = anchor.c_max(cfg) * anchor.KCL
        trunc = int((rng.s1 > rng.base + half).sum())
        check(abs(trunc - ANCHOR_TRUNCATED) <= 5,
              f"{trunc} truncated (tile, range) covers vs CPU "
              f"{ANCHOR_TRUNCATED}")
        off = ((img - ref).abs().amax(-1) > ATOL).float().mean().item()
        extra = (f", truncated (tile, range) covers {trunc} (CPU "
                 f"{ANCHOR_TRUNCATED}), pixels off the dup frame by "
                 f">{ATOL}: {off:.4e}")
    med = {k: statistics.median(v) for k, v in stages.items()}
    print(f"[{label}] {frames} frames {W}x{H}, launches "
          + " ".join(f"{k}={v}" for k, v in counts.items())
          + f", num_pairs={num_pairs} (CPU {pairs}), overflow={overflow} "
          f"(CPU {over}), visible={int(aux['num_visible'])}, mean rgb "
          f"{mean:.4f}, alpha>0.01 on {covered:.3f}{extra}; medians ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in med.items()))
    return img


def phase_step(dev, cloud, cfg, steps=7, label="5 step", kernels="AB"):
    """Forward + backward through `render`, as a training step runs it;
    `kernels` launch once per step and no other does."""
    camera = bench_camera(W, H, dev)
    leaves = {f: getattr(cloud, f).detach().clone().requires_grad_(True)
              for f in ("xyz", "log_scale", "quat", "opacity_logit", "sh")}
    weight = torch.linspace(0.5, 1.5, W, device=dev)[None, :, None]

    def step():
        for t in leaves.values():
            t.grad = None
        img, aux = render(type(cloud)(**leaves), camera, W, H, cfg)
        ((img * weight).sum() + aux["alpha"].sum()).backward()

    step()                                   # warm-up
    times = []
    reset_counts()
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    check(counts == {k: steps * (k in kernels) for k in counts},
          f"{steps} fwd+bwd steps launched {counts}")
    for name, t in leaves.items():
        check(t.grad is not None and bool(torch.isfinite(t.grad).all()),
              f"non-finite or missing gradient of {name}")
    nonzero = {k: float((v.grad != 0).any(-1).float().mean()) if v.dim() > 1
               else float((v.grad != 0).float().mean())
               for k, v in leaves.items()}
    check(nonzero["opacity_logit"] > 0.5, f"gradients too sparse: {nonzero}")
    print(f"[{label}] fwd+bwd through render at {W}x{H}: launches "
          + " ".join(f"{k}={v}" for k, v in counts.items())
          + f" in {steps} steps; median {statistics.median(times):.2f} "
          f"ms (min {min(times):.2f}); rows with a gradient: "
          + ", ".join(f"{k} {v:.3f}" for k, v in nonzero.items()))
    return statistics.median(times)


def phase_serve(dev, cloud, cfg, n_events=5, label="6 serve", kernel="A"):
    app = ViewerApp(cloud, 1280, 720, cfg, device=dev)
    events = [{"kind": "init"}, {"kind": "rotate", "dx": 0.3, "dy": 0.1},
              {"kind": "zoom", "d": -300}, {"kind": "pan", "dx": 0.05,
                                            "dy": 0.02},
              {"kind": "tick"}][:n_events]
    reset_counts()
    sizes, times = [], []
    for ev in events[:3]:
        t0 = time.perf_counter()
        frame, _ = app.handle_event(ev)
        png = encode_png(frame)
        times.append((time.perf_counter() - t0) * 1e3)
        check(frame.shape == (720, 1280, 4), f"{ev['kind']}: {frame.shape}")
        check(bool(np.isfinite(frame).all()) and frame[..., 3].max() > 0,
              f"{ev['kind']}: empty or non-finite frame")
        check(png[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
        sizes.append(len(png))
    for ev in events[3:]:                    # without the PNG encode
        frame, _ = app.handle_event(ev)
        check(frame.shape == (720, 1280, 4), f"{ev['kind']}: {frame.shape}")
    counts = launch_counts()
    check(counts == {k: len(events) * (k == kernel) for k in counts},
          f"serve launched {counts} in {len(events)} events")
    print(f"[{label}] ViewerApp 1280x720 ({cfg.binning} binning) answered "
          + ", ".join(e["kind"] for e in events)
          + f"; launches {kernel}={counts[kernel]}; PNG bytes {sizes}; ms per "
          "encoded event " + ", ".join(f"{t:.1f}" for t in times))


def run_cli(args, what):
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gaussian_splatting_web_tpu_torch.cli", *args],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"cli {what} failed:\n{proc.stderr}")
    return proc, time.perf_counter() - t0


def phase_cli_render():
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "scene100k.ply")
        write_ply(make_scene(100_000, seed=1), ply)
        out = os.path.join(tmp, "renders")
        proc, dt = run_cli(["render", "--ply", ply, "--out", out, "--device",
                            "cuda", "--width", "1280", "--height", "720"],
                           "render")
        pngs = sorted(os.listdir(out))
        check(len(pngs) == 1, f"cli wrote {pngs}")
        img = read_png(os.path.join(out, pngs[0]))
        check(img.shape == (720, 1280, 4), f"PNG shape {img.shape}")
        check(int(img[..., 3].max()) > 0, "PNG is empty")
        last = [ln for ln in proc.stderr.splitlines() if "Mpix/s" in ln]
        check(len(last) == 1, f"cli output:\n{proc.stderr}")
        print(f"[7 cli] render --device cuda on a 100k-splat PLY → "
              f"{pngs[0]} {img.shape}, alpha>0 on "
              f"{float((img[..., 3] > 0).mean()):.3f}; process {dt:.1f} s; "
              f"cli says: {last[0].split('  ', 1)[-1]}")


def orbit_camera(i, n, w, h, radius=8.0):
    a = 2 * math.pi * i / n
    return default_camera(w, h, eye=(radius * math.sin(a), 0.5,
                                     -radius * math.cos(a)),
                          center=(0, 0, 0))


def phase_train(dev, cfg, iterations=30, label="8 train", kernels="AB"):
    with torch.no_grad():
        target = make_scene(N_SCENE, seed=1, device=dev)
        views = []
        for i in range(4):
            camera = orbit_camera(i, 4, W, H)
            img, _ = render(target, camera, W, H, cfg)
            views.append(View(camera=camera, image=img.cpu().numpy(),
                              name=f"view{i}"))
        del target
    model = GaussianModel.from_cloud(make_scene(N_SCENE, seed=0, device=dev))
    loop = TrainLoopConfig(
        iterations=iterations, densify_from=20, densify_until=20,
        densify_every=20, grad_threshold=1e-7, opacity_reset_every=10_000,
        sh_upgrade_every=10, capacity_factor=2.0, log_every=1)
    log = []

    def on_log(it, loss, alive):
        torch.cuda.synchronize()
        log.append((it, loss, alive, time.perf_counter()))

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, dstate = train(model, views, W, H, render_config=cfg, loop=loop,
                          on_log=on_log, device=dev)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check(counts == {k: iterations * (k in kernels) for k in counts},
          f"train launched {counts} in {iterations} iterations")
    losses = [x[1] for x in log]
    check(len(losses) == iterations and all(map(math.isfinite, losses)),
          f"losses: {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    check(last < first, f"loss did not fall: first five {first:.5f}, last "
          f"five {last:.5f}")
    alive = [x[2] for x in log]
    densified = iterations > loop.densify_from
    check(alive[-1] != alive[0] or not densified,
          f"alive count unchanged at {alive[0]}")
    for f in PARAMS:
        check(bool(torch.isfinite(getattr(state.model, f)).all()),
              f"non-finite {f} after training")
    per_it = [(b[3] - a[3]) * 1e3 for a, b in zip(log, log[1:])]
    print(f"[{label}] {iterations} iterations at {W}x{H} from {N_SCENE} "
          f"splats (arena {state.model.num_gaussians}, {cfg.binning} "
          "binning), launches "
          + " ".join(f"{k}={v}" for k, v in counts.items())
          + f"; loss first five {first:.5f} → last five {last:.5f}; "
          f"alive {alive[0]} → {alive[-1]}"
          + (" (densify at 20)" if densified else "") + "; ms/iteration "
          f"median {statistics.median(per_it):.2f}, mean "
          f"{statistics.mean(per_it):.2f}; wall {wall:.1f} s incl. set-up; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts


def phase_cli_train(dev, cfg):
    w, h = 320, 240
    with tempfile.TemporaryDirectory() as tmp:
        images = os.path.join(tmp, "images")
        os.makedirs(images)
        scene = make_scene(20_000, seed=2, log_scale_range=(-4.5, -3.0),
                           device=dev)
        entries = []
        with torch.no_grad():
            for i in range(3):
                camera = orbit_camera(i, 8, w, h)
                img, _ = render(scene, camera, w, h, cfg)
                write_png(img.cpu().numpy(), os.path.join(images,
                                                          f"view{i}.png"))
                entries.append({
                    "id": i, "img_name": f"view{i}", "width": w, "height": h,
                    "position": camera.cam_pos.tolist(),
                    "rotation": camera.view[:3, :3].T.tolist(),
                    "fx": float(camera.focal[0]),
                    "fy": float(camera.focal[1])})
        cams = os.path.join(tmp, "cameras.json")
        with open(cams, "w") as f:
            json.dump(entries, f)
        init = os.path.join(tmp, "init.ply")
        write_ply(make_scene(20_000, seed=3, log_scale_range=(-4.5, -3.0)),
                  init)
        out = os.path.join(tmp, "trained.ply")
        proc, dt = run_cli(["train", "--cameras", cams, "--images", images,
                            "--ply", init, "--out", out, "--iterations", "20",
                            "--width", str(w), "--height", str(h),
                            "--device", "cuda"], "train")
        trained = read_ply(out, device=dev)
        check(trained.num_gaussians > 0 and bool(
            torch.isfinite(trained.xyz).all()), "trained PLY is empty")
        said = [ln for ln in proc.stderr.splitlines() if "saved" in ln]
        print(f"[9 cli] train --device cuda on 3 PNG views {w}x{h}, 20 "
              f"iterations → PLY with {trained.num_gaussians} gaussians "
              f"(SH {trained.sh_degree}); process {dt:.1f} s; cli says: "
              f"{said[-1] if said else proc.stderr[-200:]}")


def main():
    t_run = time.perf_counter()
    dev = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    cfg = RenderConfig()
    cfg_a = RenderConfig(binning="anchor")
    with torch.no_grad():
        t0 = time.perf_counter()
        cloud = make_scene(N_SCENE, seed=0, sh_degree=3, device=dev)
        print(f"[scene] make_scene({N_SCENE}) on {dev} in "
              f"{time.perf_counter() - t0:.1f} s")
        fwd, full = phase_kernel(dev, cloud, cfg)
        bwd = phase_backward(dev, cfg, full)
        del full
        frame = phase_render(dev, cloud, cfg)
        afwd, afull = phase_anchor_kernel(dev, cloud, cfg_a)
        abwd = phase_anchor_backward(dev, cfg_a, afull)
        del afull
        phase_render(dev, cloud, cfg_a, ref=frame)
    phase_step(dev, cloud, cfg)
    phase_step(dev, cloud, cfg_a, label="13 anchor", kernels="CD")
    with torch.no_grad():
        phase_serve(dev, cloud, cfg)
        phase_serve(dev, cloud, cfg_a, n_events=2, label="13 anchor",
                    kernel="C")
    del cloud
    phase_cli_render()
    trained = phase_train(dev, cfg)
    trained_a = phase_train(dev, cfg_a, iterations=10, label="14 anchor",
                            kernels="CD")
    phase_cli_train(dev, cfg)
    results = {"raster_fwd": fwd, "raster_bwd": bwd, "anchor_fwd": afwd,
               "anchor_bwd": abwd}
    launches = {"raster_fwd": trained["A"], "raster_bwd": trained["B"],
                "anchor_fwd": trained_a["C"], "anchor_bwd": trained_a["D"]}
    print(f"[wall] {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches[name],
        **{k: results[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")}}
        for name, (src, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
