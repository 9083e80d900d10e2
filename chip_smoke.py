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
  1 build    nvcc builds the six kernel sources (csrc/raster_fwd.cu,
             raster_bwd.cu, anchor_fwd.cu, anchor_bwd.cu, which share
             csrc/tile_walk.cuh, the projection's project.cu and
             binning's bin.cu), one process each, started together
  2 kernel   kernel A vs its plain PyTorch twin on the same bins: an
             opaque early-exit scene, a 72x40 ragged frame, a 96x64
             adversarial scene (`bench_lib.make_adversarial_scene`:
             needles, centres off the frame, opacities at the cutoff,
             sub-pixel splats, splats past max_dup) and the full 1080p
             frame; on each, the footprint cull's plain mirror against
             the twin's power (no culled step may pass the cutoff; the
             culled share is printed); A's tile schedule at 1080p against
             its plain twin; A timed at 1080p alone and through its
             wrapper
  3 bwd      kernel B vs its plain twin on the same four scenes, after
             the fold (the gradient-parity gate below), bitwise
             repeatable on each; B's schedule against its twin; B alone,
             B through its wrapper, its twin and the fold timed at 1080p
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
             below the first five, a changed alive count; ms/iteration;
             the views are written as a capture (PNGs, cameras.json) and
             the trained scene as a PLY for phase 17
  9 cli      `cli train --device cuda` on a small synthetic capture (PNGs
             and cameras.json written here) writes a PLY `read_ply` loads

The anchor-binning path (`RenderConfig(binning="anchor")`, kernels C and D,
default caps: 1,536-position covers, k_cap 1024):

 10 anchor   kernel C vs its plain twin on the same anchor bins: the opaque,
             ragged and adversarial scenes, a crowded 64x48 scene whose
             ranges overrun their cover and whose tiles hold more than
             k_cap candidates, a 64x48 scene where a range A splits its
             columns past its cover while range B holds candidates below
             that split, and 1080p; identical ordered lists, the
             image rule, and on each the footprint cull's mirror over C's
             ordered lists (0 culled passing steps, culled share printed);
             C's tile schedule a permutation in descending class of the
             union its merge reads, as its plain twin's; C alone, through
             its wrapper and its twin timed at 1080p
 11 anchor   kernel D vs its plain twin after the fold on the same scenes
             (the gradient rule), bitwise repeatable on each; D's tile
             schedule against its twin (by k_used); D alone, through its
             wrapper, its twin and the fold timed at 1080p
 12 anchor   `render` at 1080p for a few frames: one C launch per frame, no
             A or B; entries, overflow and truncated ranges against the JAX
             package's CPU figures; per-stage medians; the share of pixels
             off the dup path's frame by more than 2e-4 (printed, not gated)
 13 anchor   fwd+bwd through `render` at 1080p, C and D once per step,
             finite parameter gradients; `ViewerApp` answers two events
 14 anchor   `train()` as phase 8 with binning='anchor': C and D once per
             iteration, finite losses that fall; ms/iteration

Tile sharding (A's and B's tile-list entries E-A and E-B, `parallel/`):

 15 tiles    at 1080p, the tiles of 4 shards (`_padded_tile_ids(8160, 4,
             32)`, padding turned into the empty sentinel) composited by
             E-A one shard after another: stitched, equal to full-frame A's
             image and residual bit for bit; E-B with each shard's slice of
             one cotangent: rows that add up to full-frame B's bit for bit;
             the same on the opaque, ragged and adversarial scenes (5
             shards of 2-tile chunks); on each, E-A against the list twin
             by the image rule and E-B against it by the gradient rule; E-A's
             schedule of list positions heavy first; E-A and E-B timed over
             one shard's list beside full-frame A and B in the same phase
 16 sharded  a one-rank NCCL group (`file://` store), kept open for
             phase 18: `render_sharded` equal to phase 4's `render` bit
             for bit, one E-A and one P launch; one
             `make_sharded_train_step` step on two 1080p views: loss equal
             to the unsharded loss (rel 1e-5), gradients by the gradient
             rule, E-A, E-B, P and P bwd twice each and no other kernel
 17 eval     `cli eval --device cuda` on phase 8's capture and trained PLY
             prints its JSON line with a finite PSNR

Gaussian sharding (`parallel/gaussian_sharded.py`, E-A and E-B through
`composite_tiles_auto`) and the config leftovers:

 18 gsharded on phase 16's one-rank NCCL group: `render_gaussian_sharded`
             and `render_gaussian_sharded_banded` with stream "a2a" and
             "ring" equal to phase 4's `render` bit for bit with overflow
             0, one E-A and one P launch each; one ring, one banded a2a
             and one banded ring-stream `make_gaussian_sharded_train_step`
             step on phase 16's two views against the unsharded loss (rel
             1e-5) and gradients (the gradient rule), E-A, E-B, P and P bwd
             2 each and no other kernel; `dryrun_multichip(1)` in the
             group
 19 config   `debug_selected` on a splat near the centre through kernel A
             (`render`, `rasterize_tiles`) against the plain twin on the
             same highlighted fields (the image rule); a
             `dtype="bfloat16"` render through A against the twin on the
             same bf16 inputs (the image rule) and against phase 4's f32
             frame (mean |diff| < 5e-3, p99 < 0.05, JAX
             tests/test_rasterize.py:155-176)

The packed and tiered modes, the JAX package's default render
configuration (CFG_P: depth_bits=19, tier_split=2, pack_fields,
pack_mean16, pack_grads; CFG_CULL: CFG_P with tile_cull; CFG_AP: the
packed anchor binning):

 20 packed   the bins of all three at 1080p against the JAX package's CPU
             figures (num_pairs, overflow; slots and pair cap, the largest
             tile); phases 2, 3 and 15 rerun under CFG_P (A, B, E-A and E-B
             with the mean16 flag, the tiered pack_grads fold, the cull
             mirror's 0 culled passing steps) and phases 10 and 11 under
             CFG_AP (C and D on packed anchor bins, the crowded and column
             overrun scenes included); `render` and a fwd+bwd step in each
             mode (one A or C per frame, A+B or C+D per step), each frame
             against phase 4's exact frame (mean |diff| < 5e-3, p99 <
             0.05); `train()` for 10 iterations under CFG_P; the packed
             keys' stable sort timed as int64 and as int32; a line
             "[20 packed] against the exact mode of this run" with the
             per-stage, step, fold and kernel times beside the exact mode's

The bench (`bench_lib.run`, `cli bench`) and the native PLY unpack:

 21 bench    `bench_lib.run(emit_json=False)` on the 1M scene at 1080p in the
             port's default exact mode: its gradient-parity gate (kernels A
             and B against their plain twins on the same bins) ran and is
             green, live pairs and overflow as phase 4 holds them, every
             roofline share in (0, 100], and the forward median within 25%
             of the median of 20 frames timed as phase 4 times them, just
             before `run()`; the result dict on one line. The
             gate again with the kernel path's gradient scaled: by 1.1 at
             1080p and by 1.01 on 20,000 splats at 320x240 it must be red
             (by 1.01 at 1080p it is printed: there its p99 stays under
             the 1e-3 limit). `cli bench --width 1280 --height 720` as a subprocess
             exits 0 with one JSON line holding parity_gate_ok true. Phase
             4's scene written with `write_ply` reads back through
             `read_ply(use_native=True)` and `(use_native=False)` equal bit
             for bit (host clock, 3 reads each)

The projection's kernels (`csrc/project.cu`, `ops/cuda/project.py`):

 22 project  P fwd and P bwd through `project_gaussians` at 1080p on the 1M
             SH-degree-3 scene: the forward against
             `project_gaussians_plain` (`bench_lib.projection_parity`:
             every float field within rtol 1e-5, radius and valid rows
             excused only at an integer pre-ceil radius or the frame's
             edge, at most 1e-4 of the rows) and every input's gradient
             against autograd of the forward twin in float64
             (`bench_lib.projection_grad_parity`: rows within 2e-3, the
             median row within 1e-5, rows on a select's or clamp's switch
             point left out), the rules of tests/test_torch_project_cuda.py;
             P=2 and P-bwd=1 launches; both timed alone and their twins

Binning's kernels (`csrc/bin.cu`, `ops/cuda/bin.py`):

 23 binning  `bin_splats` (the CUDA kernels) against `bin_splats_plain`
             (the PyTorch path) on the same projected splats at
             `mipnerf360`'s 2.96M Gaussians and 1237x822, `tandt`'s 1.66M
             and 979x546, and 1M at 1080p: every TileBins field equal bit
             for bit, one launch and one host sync a call; both timed
             whole (CUDA events around one call, median of 7) against
             `bench_lib.binning_bytes` at 3.35 TB/s

The optimizer's kernel (`csrc/adam.cu`, `ops/cuda/adam.py`):

 24 adam     one launch of csrc/adam.cu over the six leaves (59 floats a
             row) at `mipnerf360`'s 2.96M rows, `tandt`'s 1.66M and a
             `rubble` rank's 10.1M: one step against `adam_plain` from the
             same state on the card (p, m and v within 4 ulp of the
             magnitudes they add up), `Adam.step()` one launch; the kernel
             alone (CUDA events), the whole `step()`, `adam_plain` and
             `torch.optim.Adam(foreach=True)`'s step on the same tensors
             (the yardstick `library_ms`, which the port never calls),
             against the 28-B floor (read p, g, m and v, write p, m and v)
             at 3.35 TB/s

Every phase that renders or trains counts P and P bwd with the other
kernels: one P launch a frame, one P and one P bwd launch a step; and
binning's calls ("bin"): one a frame or step that bins through
`csrc/bin.cu` (the dup binning with single-tier duplication), none in the
anchor and tiered modes. Every phase that trains counts the optimizer's
launches ("adam"): one a training step (phases 8, 14, 16, 18, 20).

Image rule (tests/conftest.py::assert_images_close): at most 2e-4 of the
pixels may differ by more than 2e-4; on the pixels that agree, the
residual log-transmittance agrees to 1e-4. Gradient rule
(bench_lib.grad_parity_ok): over the folded [N, 9] gradients, p99 of
|kernel − twin| / max|twin| per column ≤ 1e-3, and at most 1e-5 of the
elements plus 2 off by more than 1%. TF32 is switched off for matmuls and
cuDNN so the plain twins and SSIM compute in full f32.

Kernel times: "kernel" is the launch alone (`prepare_*` does the checks
and allocations first; CUDA events around 5 back-to-back launches, divided
by 5, median of 7 samples after warm-up; every launch includes its
one-block tile-schedule kernel), the time in the JSON line;
"wrapper" is the whole wrapper call (checks, allocations, launch) between
CUDA events, median of 7; the plain twins are timed that way too. C, D, P
fwd and P bwd are timed with the same helpers (P bwd with random
gradients of mean2d, conic, rgb and opacity, none of depth, as in
training; its twin `project_backward_plain` on the same tensors).

Each kernel's bound (`bench_lib.work`, `bound`, `raster_bytes`, shared
with the bench's roofline rows) is the larger of its bytes (each input read once, each
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
records). C's bytes add its merge's union loads (1 meta byte per position
read, every tile's two covers, and the 4-byte depth of each touched
position) and its ordered-list outputs; its merge's compares are not
counted as operations. D's bytes count the ordered lists it reads and the
rows it writes (36 bytes per kept pair), not the zeroed array.
E-A's and E-B's bound counts the listed tiles only: their pairs' ids,
their splats' 48-byte rows (each splat once), the list with its starts
and counts, and the slots written (rgba, log-T and last index); E-B also
reads the cotangent and writes 36 bytes per listed pair. Their steps are
A's and B's over those tiles. P fwd's and P bwd's bound is their bytes
alone, each input read once and each output written once:
`bench_lib.P_FWD_BYTES` (281) and `P_BWD_BYTES` (508) a splat at SH
degree 3.

Prints the card line, a JSON line of kernel results, and last
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from gaussian_splatting_web_tpu_torch import bench_lib
from gaussian_splatting_web_tpu_torch.bench_lib import (
    ADAM_BYTES,
    ADAM_ULPS,
    GRAD_EXTRA,
    HBM_BYTES_S,
    P_BWD_BYTES,
    P_FWD_BYTES,
    PROJ_INPUTS,
    adam_ulp_gap,
    binning_bytes,
    bound,
    grad_parity,
    grad_parity_ok,
    make_adversarial_scene,
    make_scene,
    orbit_camera,
    projection_grad_parity,
    projection_grads_vs_f64,
    projection_parity,
    raster_bytes,
    step_parity,
    unsharded_reference,
    work,
)
from gaussian_splatting_web_tpu_torch.bench_lib import IMAGE_ATOL as ATOL
from gaussian_splatting_web_tpu_torch.bench_lib import (
    IMAGE_BAD_FRAC as MAX_BAD_FRAC,
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
from gaussian_splatting_web_tpu_torch.ops.cuda import adam as adam_cuda
from gaussian_splatting_web_tpu_torch.ops.cuda import anchor as anchor_cuda
from gaussian_splatting_web_tpu_torch.ops.cuda import build
from gaussian_splatting_web_tpu_torch.ops.cuda import project as project_cuda
from gaussian_splatting_web_tpu_torch.ops.cuda import raster as raster_cuda
from gaussian_splatting_web_tpu_torch.ops.projection import (
    pack_camera,
    project_backward_plain,
    project_gaussians,
    project_gaussians_plain,
)
from gaussian_splatting_web_tpu_torch.ops.rasterize import (
    composite_backward_plain,
    composite_image_plain,
    fold_pair_grads,
    pack_splat_fields,
    rasterize_tiles,
    render,
)
from gaussian_splatting_web_tpu_torch.ops.sort import (
    bin_splats,
    bin_splats_plain,
    float_to_sortable_uint,
    sort_key_bits,
    takes_kernels,
)
from gaussian_splatting_web_tpu_torch.parallel import (
    banded_candidates,
    banded_candidates_a2a,
    banded_cap_hop,
    banded_tile_rows,
    init_sharded_train_state,
    make_gaussian_sharded_train_step,
    make_mesh,
    make_sharded_train_step,
    render_gaussian_sharded,
    render_gaussian_sharded_banded,
    render_sharded,
    shard_model,
)
from gaussian_splatting_web_tpu_torch.parallel.dryrun import dryrun_multichip
from gaussian_splatting_web_tpu_torch.parallel.render_sharded import (
    shard_tile_ids,
)
from gaussian_splatting_web_tpu_torch.train.checkpoint import save_ply
from gaussian_splatting_web_tpu_torch.train.densify import compact
from gaussian_splatting_web_tpu_torch.train.train_loop import (
    TrainLoopConfig,
    train,
)
from gaussian_splatting_web_tpu_torch.train.trainer import (
    TrainState,
    make_optimizer,
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
# the packed and tiered modes (phase 20): the JAX package's default values
# of the item-12 fields, that with the exact ellipse-tile cull, and the
# packed anchor binning
CFG_P = RenderConfig(depth_bits=19, tier_split=2, pack_fields=True,
                     pack_mean16=True, pack_grads=True)
CFG_CULL = CFG_P.replace(tile_cull=True)
CFG_AP = RenderConfig(binning="anchor", pack_fields=True, pack_grads=True)
# the JAX package's CPU run of the same projection and binning in those
# modes (PERF.md §4): live pairs and overflow; the tiered slot grid (2·N +
# 4·0.3N + 16·N/64) and the largest tile's pair count
PACKED_PAIRS, PACKED_OVERFLOW, PACKED_MAX_TILE = 2_150_328, 13, 1_724
CULL_PAIRS, CULL_OVERFLOW, CULL_MAX_TILE = 1_759_864, 13, 1_409
PACKED_SLOTS, PACKED_PAIR_CAP = 3_450_000, 3_000_000
ANCHOR_PACKED_PAIRS, ANCHOR_PACKED_OVERFLOW = 2_150_377, 248
LOG_T_TOL = 1e-4          # the image rule and GRAD_EXTRA: bench_lib
TILE_SHARDS, TILE_CHUNK = 4, 32   # phase 15's tile deal (the default chunk)
# phase 23: the benchmark's two scene sizes and this run's frame
BIN_SCENES = ((2_960_000, 1237, 822), (1_660_000, 979, 546), (N_SCENE, W, H))
BIN_FIELDS = ("sorted_gidx", "sorted_slot", "tile_start", "tile_count",
              "num_pairs", "overflow")
KERNELS = {
    "raster_fwd": ("gaussian_splatting_web_tpu_torch/csrc/raster_fwd.cu",
                   "gaussian_splatting_web_tpu/ops/pallas/raster.py:219"),
    "raster_bwd": ("gaussian_splatting_web_tpu_torch/csrc/raster_bwd.cu",
                   "gaussian_splatting_web_tpu/ops/pallas/raster_bwd.py:64"),
    "anchor_fwd": ("gaussian_splatting_web_tpu_torch/csrc/anchor_fwd.cu",
                   "gaussian_splatting_web_tpu/ops/pallas/anchor.py:639"),
    "anchor_bwd": ("gaussian_splatting_web_tpu_torch/csrc/anchor_bwd.cu",
                   "gaussian_splatting_web_tpu/ops/pallas/anchor.py:928"),
    # A's and B's tile-list entries (E), in A's and B's sources
    "raster_fwd_tiles": (
        "gaussian_splatting_web_tpu_torch/csrc/raster_fwd.cu",
        "gaussian_splatting_web_tpu/ops/pallas/raster.py:509 "
        "composite_tiles_pallas(tile_ids=)"),
    "raster_bwd_tiles": (
        "gaussian_splatting_web_tpu_torch/csrc/raster_bwd.cu",
        "gaussian_splatting_web_tpu/ops/pallas/raster_bwd.py:449 "
        "backward_pair_grads(tile_ids=)"),
    # no TPU kernel: the JAX package's projection is XLA
    "project_fwd": ("gaussian_splatting_web_tpu_torch/csrc/project.cu",
                    "gaussian_splatting_web_tpu/ops/projection.py "
                    "project_gaussians (XLA)"),
    "project_bwd": ("gaussian_splatting_web_tpu_torch/csrc/project.cu",
                    "gaussian_splatting_web_tpu/ops/projection.py "
                    "project_gaussians's autodiff (XLA)"),
    # no TPU kernel: the JAX package's binning is XLA
    "bin": ("gaussian_splatting_web_tpu_torch/csrc/bin.cu",
            "gaussian_splatting_web_tpu/ops/sort.py bin_splats (XLA)"),
    # no TPU kernel: the JAX package's Adam is optax's, under XLA
    "adam": ("gaussian_splatting_web_tpu_torch/csrc/adam.cu",
             "gaussian_splatting_web_tpu/train/trainer.py make_optimizer "
             "(optax.adam, XLA)"),
}
SOURCES = ("raster_fwd", "raster_bwd", "anchor_fwd", "anchor_bwd", "project",
           "bin", "adam")
# phase 24: rows of the benchmark's two one-card scenes and of a `rubble`
# rank; a row's leaves (xyz, log-scale, quaternion, opacity, SH DC, SH
# rest) and their floats
ADAM_ROWS = (2_960_000, 1_660_000, 10_100_000)
ADAM_SHAPES = ((3,), (3,), (4,), (), (1, 3), (15, 3))
ADAM_FLOATS = 59


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def binned_by_kernels(cfg, kernels):
    """("bin",) where `kernels` holds A (or E-A), whose bins `bin_splats`
    makes with csrc/bin.cu under cfg (single-tier duplication), else ()."""
    return (("bin",) if "A" in kernels
            and takes_kernels(torch.device("cuda"), cfg) else ())


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
    return pack_splat_fields(splats, cfg), bins


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
    build.load_all(SOURCES)
    dt = time.perf_counter() - t0
    parts = []
    for name in SOURCES:
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


def schedule_check(order, weight, cap, what):
    """A kernel's heavy-first schedule: a permutation of the tiles whose
    weight classes fall along it as along the plain twin's."""
    t = weight.shape[0]
    check(torch.equal(torch.sort(order.long()).values,
                      torch.arange(t, device=order.device)),
          f"{what}: the tile schedule is not a permutation of the tiles")
    cls = raster_cuda.order_class(weight, cap)
    want = raster_cuda.heavy_first_order(weight, cap).long()
    check(torch.equal(cls[order.long()], cls[want]),
          f"{what}: the tile schedule is not heavy first")


def phase_kernel(dev, cloud, cfg, label="2 kernel"):
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
    prepared = raster_cuda.prepare_fwd(fields, bins, W, H, cfg)
    ms = kernel_ms(prepared)
    schedule_check(prepared[1][1], bins.tile_count, cfg.max_per_tile,
                   "kernel A")
    wrapper_ms = median_ms(
        lambda: raster_cuda.composite_image(fields, bins, W, H, cfg), 7)
    plain_ms = median_ms(
        lambda: composite_image_plain(fields, bins, W, H, cfg), 7, warmup=1)
    findings["1080p"] = full
    steps = work(fields, bins, got, W, H, cfg)
    nbytes = raster_bytes(fields, bins, W, H, cfg)
    bound_ms, bound_by, step_ms = bound("raster_fwd", steps["A"], nbytes)
    print(f"[{label}] kernel A vs plain twin: "
          + "; ".join(f"{k}: max_abs_err {v['max_abs_err']:.3e}, "
                      f">{ATOL} on {v['bad_frac']:.2e}, "
                      f"log-T err {v['log_t_err']:.2e}, "
                      f"last-idx diff {v['last_idx_frac']:.2e}, "
                      f"culled {v['culled']:.4f} of the steps, 0 passing"
                      for k, v in findings.items())
          + f"; schedule heavy first; 1080p kernel {ms:.3f} ms, wrapper "
          f"{wrapper_ms:.3f} ms, plain {plain_ms:.3f} ms; "
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
    g_got = fold_pair_grads(got, bins, n, cfg)
    g_want = fold_pair_grads(want, bins, n, cfg)
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite B output")
    check(g_want.abs().max().item() > 0, f"{what}: zero gradients")
    stats = grad_parity(g_got.T, g_want.T)
    stats["max_abs_err"] = (g_got - g_want).abs().max().item()
    check(grad_parity_ok(stats, GRAD_EXTRA),
          f"{what}: kernel B vs twin outside the gradient rule: {stats}")
    return stats, (d_rgb, d_alpha, got)


def phase_backward(dev, cfg, full, label="3 bwd"):
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
    prepared = raster_cuda.prepare_bwd(fields, bins, W, H, cfg, fwd, d_rgb,
                                       d_alpha)
    ms = kernel_ms(prepared)
    schedule_check(prepared[1][1], bins.tile_count, cfg.max_per_tile,
                   "kernel B")
    wrapper_ms = median_ms(lambda: raster_cuda.composite_backward(
        fields, bins, W, H, cfg, fwd, d_rgb, d_alpha), 7)
    plain_ms = median_ms(lambda: composite_backward_plain(
        fields, bins, W, H, cfg, fwd, d_rgb, d_alpha), 7, warmup=1)
    n = fields.shape[0]
    fold_ms = median_ms(lambda: fold_pair_grads(dpairs, bins, n, cfg), 7)
    nbytes = raster_bytes(fields, bins, W, H, cfg, dpairs)
    bound_ms, bound_by, step_ms = bound("raster_bwd", steps["B"], nbytes)
    print(f"[{label}] kernel B vs plain twin after the fold, bitwise "
          "repeatable on each scene: "
          + "; ".join(f"{k}: p99 {v['p99']:.2e}, max {v['max']:.2e}, "
                      f">1% {v['nbig']}/{v['n']}, "
                      f"max_abs_err {v['max_abs_err']:.3e}"
                      for k, v in findings.items())
          + f"; schedule heavy first; 1080p kernel {ms:.3f} ms, wrapper "
          f"{wrapper_ms:.3f} ms, plain {plain_ms:.3f} ms, fold "
          f"{fold_ms:.3f} ms; "
          + work_line(steps["B"], nbytes, bound_ms, bound_by, step_ms,
                      "contributing"))
    return {"max_abs_err": findings["1080p"]["max_abs_err"], "ms": ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "fold_ms": fold_ms}


def shard_strips(t, shards=TILE_SHARDS, chunk=TILE_CHUNK, dev="cuda"):
    """Each tile shard's strip of `_padded_tile_ids(t, shards, chunk)`,
    its padding turned into the empty sentinel t."""
    return [shard_tile_ids(t, shards, chunk, s).to(dev)
            for s in range(shards)]


def tiles_vs_full(fields, bins, w, h, cfg, what, shards=TILE_SHARDS,
                  chunk=TILE_CHUNK, twins=True):
    """Kernel A's and B's tile-list entries over the strips of `shards`
    tile shards, run in turn: the stitched E-A tiles equal full-frame A's
    image and residual bit for bit, the sentinel slots are empty, and the
    strips' E-B rows (one cotangent, cut into the strips) add up to
    full-frame B's rows bit for bit. With `twins`, each strip's E-A against
    the list twin by the image rule (pixels inside the frame) and its E-B
    against the list twin after the fold by the gradient rule → findings,
    with the first strip's inputs."""
    dev = fields.device
    gx, gy = cfg.grid_size(w, h)
    t = gx * gy
    full = raster_cuda.composite_image(fields, bins, w, h, cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    d_rgb = torch.randn((h, w, 3), generator=gen, device=dev)
    d_alpha = torch.randn((h, w), generator=gen, device=dev)
    rows_full = raster_cuda.composite_backward(fields, bins, w, h, cfg, full,
                                               d_rgb, d_alpha)
    cot = rasterize.tile_major(torch.cat([d_rgb, d_alpha[..., None]], -1),
                               gx, gy, 16)
    inside = rasterize.tile_major(torch.ones((h, w, 1), device=dev), gx, gy,
                                  16)[..., 0] > 0
    stitched = torch.zeros((t, 256, 6), device=dev)
    rows = torch.zeros_like(rows_full)
    n = fields.shape[0]
    found = {"fwd_err": 0.0, "bad_frac": 0.0, "p99": 0.0, "bwd_err": 0.0,
             "sentinels": 0}
    first = None
    for ids in shard_strips(t, shards, chunk, dev):
        real = ids < t
        out = raster_cuda.composite_forward(fields, bins, w, h, cfg,
                                            tile_ids=ids)
        check(not bool(out.rgba[~real].any()) and bool(
            (out.last_idx[~real] == -1).all()),
            f"{what}: a sentinel slot is not empty")
        found["sentinels"] += int((~real).sum())
        stitched[ids[real].long()] = torch.cat(
            [out.rgba, out.final_log_t[..., None],
             out.last_idx[..., None].float()], -1)[real]
        d_list = torch.where(real[:, None, None],
                             cot[ids.clamp(max=t - 1).long()], 0.0)
        part = raster_cuda.composite_backward(fields, bins, w, h, cfg, out,
                                              d_list, tile_ids=ids)
        rows += part
        if first is None:
            first = (ids, out, d_list, part)
        if not twins:
            continue
        rgba, _, _ = rasterize.composite_tiles(fields, bins, ids, gx, cfg)
        keep = inside[ids.clamp(max=t - 1).long()] & real[:, None]
        diff = (out.rgba - rgba).abs().amax(-1)[keep]
        bad = (diff > ATOL).float().mean().item()
        check(bad <= MAX_BAD_FRAC, f"{what}: E-A vs its twin: {bad:.2e} of "
              f"the pixels differ > {ATOL}")
        found["fwd_err"] = max(found["fwd_err"], diff.max().item())
        found["bad_frac"] = max(found["bad_frac"], bad)
        want = rasterize.composite_tiles_backward_plain(
            fields, bins, ids, w, h, cfg, out.last_idx, d_list)
        g_got = fold_pair_grads(part, bins, n, cfg)
        g_want = fold_pair_grads(want, bins, n, cfg)
        stats = grad_parity(g_got.T, g_want.T)
        check(grad_parity_ok(stats, GRAD_EXTRA),
              f"{what}: E-B vs its twin outside the gradient rule: {stats}")
        found["p99"] = max(found["p99"], stats["p99"])
        found["bwd_err"] = max(found["bwd_err"],
                               (g_got - g_want).abs().max().item())
    img = rasterize.assemble_image(stitched, w, h, gx, gy)
    check(torch.equal(img[..., :3], full.rgb)
          and torch.equal(img[..., 3], full.alpha)
          and torch.equal(img[..., 4], full.final_log_t)
          and torch.equal(img[..., 5].int(), full.last_idx),
          f"{what}: the stitched E-A tiles differ from full-frame A")
    check(torch.equal(rows, rows_full) and rows.abs().max().item() > 0,
          f"{what}: the strips' E-B rows do not add up to full-frame B's")
    return found, first


def phase_tiles(dev, cfg, full, label="15 tiles"):
    """Phase 15: E-A and E-B over 4 tile shards at 1080p and on the small
    scenes; both timed over one shard's list beside full-frame A and B."""
    findings = {}
    for what, scene, w, h, z in small_scenes(dev):
        camera = default_camera(w, h, eye=(0, 0, z), center=(0, 0, 0)).to(dev)
        fields, bins = binned(scene, camera, w, h, cfg)
        findings[what], _ = tiles_vs_full(fields, bins, w, h, cfg, what,
                                          shards=5, chunk=2)
    fields, bins, comp, _ = full
    findings["1080p"], (ids, out, d_list, dpairs) = tiles_vs_full(
        fields, bins, W, H, cfg, "1080p")
    d_rgb = torch.ones((H, W, 3), device=dev)
    d_alpha = torch.ones((H, W), device=dev)
    times = {
        "E-A": kernel_ms(raster_cuda.prepare_fwd(fields, bins, W, H, cfg,
                                                 tile_ids=ids)),
        "E-B": kernel_ms(raster_cuda.prepare_bwd(fields, bins, W, H, cfg, out,
                                                 d_list, tile_ids=ids)),
        "A": kernel_ms(raster_cuda.prepare_fwd(fields, bins, W, H, cfg)),
        "B": kernel_ms(raster_cuda.prepare_bwd(fields, bins, W, H, cfg, comp,
                                               d_rgb, d_alpha)),
    }
    run, (_, order) = raster_cuda.prepare_fwd(fields, bins, W, H, cfg,
                                              tile_ids=ids)
    run()
    capped = torch.clamp(torch.nn.functional.pad(bins.tile_count, (0, 1)),
                         max=cfg.max_per_tile)[ids.long()]
    schedule_check(order, capped, cfg.max_per_tile, "E-A")
    gx, _ = cfg.grid_size(W, H)
    plain = {
        "E-A": median_ms(lambda: rasterize.composite_tiles(
            fields, bins, ids, gx, cfg), 7, warmup=1),
        "E-B": median_ms(lambda: rasterize.composite_tiles_backward_plain(
            fields, bins, ids, W, H, cfg, out.last_idx, d_list), 7,
            warmup=1),
    }
    steps = work(fields, bins, comp, W, H, cfg, tile_ids=ids)
    real = ids[ids < cfg.num_tiles(W, H)].long()
    starts = bins.tile_start[real].long()
    counts = torch.clamp(bins.tile_count[real], max=cfg.max_per_tile).long()
    n_pairs = int(counts.sum())
    pos = torch.repeat_interleave(starts, counts) + (
        torch.arange(n_pairs, device=dev)
        - torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts))
    splats = int(torch.unique(bins.sorted_gidx[pos]).numel())
    n_ids = ids.shape[0]
    # inputs: the listed tiles' pair ids, their splats' rows, the list and
    # its starts and counts; outputs: the slots (rgba, log-T, last index)
    bytes_in = n_pairs * 4 + splats * 48 + n_ids * 12
    nbytes = {"E-A": bytes_in + n_ids * 256 * 24,
              "E-B": bytes_in + n_ids * 256 * 24 + n_pairs * 36}
    results = {}
    for name, key, wk in (("raster_fwd_tiles", "E-A", steps["A"]),
                          ("raster_bwd_tiles", "E-B", steps["B"])):
        bound_ms, bound_by, step_ms = bound(name, wk, nbytes[key])
        results[name] = {
            "max_abs_err": findings["1080p"]["fwd_err" if key == "E-A"
                                             else "bwd_err"],
            "ms": times[key], "plain_ms": plain[key], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "work": work_line(wk, nbytes[key], bound_ms, bound_by, step_ms,
                              "past the cutoff" if key == "E-A"
                              else "contributing")}
    print(f"[{label}] E-A and E-B over {TILE_SHARDS} tile shards "
          f"(`_padded_tile_ids(T, {TILE_SHARDS}, {TILE_CHUNK})`, padding → "
          "the empty sentinel), run in turn: stitched E-A equal to A bit "
          "for bit (image and residual), E-B rows summed equal to B's bit "
          "for bit, on "
          + ", ".join(findings) + "; against the list twins: "
          + "; ".join(f"{k}: E-A max_abs_err {v['fwd_err']:.3e}, "
                      f">{ATOL} on {v['bad_frac']:.2e}, E-B p99 "
                      f"{v['p99']:.2e}, max_abs_err {v['bwd_err']:.3e}, "
                      f"{v['sentinels']} sentinel slots"
                      for k, v in findings.items())
          + f"; one shard's list at 1080p ({n_ids} positions, "
          f"{int(real.numel())} tiles, {n_pairs} pairs, {splats} splats): "
          f"kernel E-A {times['E-A']:.3f} ms, E-B {times['E-B']:.3f} ms, "
          f"full-frame A {times['A']:.3f} ms, B {times['B']:.3f} ms in the "
          f"same phase; plain E-A {plain['E-A']:.3f} ms, E-B "
          f"{plain['E-B']:.3f} ms; E-A "
          + results["raster_fwd_tiles"]["work"] + "; E-B "
          + results["raster_bwd_tiles"]["work"])
    return results


@contextlib.contextmanager
def one_rank_group():
    """A one-rank NCCL process group (`file://` store) → its 1 × 1 mesh;
    phases 16 and 18 run in it."""
    torch.cuda.set_device(torch.cuda.current_device())
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            yield make_mesh()
        finally:
            dist.destroy_process_group()


def sharded_step_check(step, state, ref, what):
    """One sharded step on `bench_lib.unsharded_reference`'s two views
    against its loss and gradients (`bench_lib.step_parity`) → (counts,
    step ms, loss, parity); E-A 2, E-B 2, P 2 and P-bwd 2 (each view
    projected once), adam 1 (one optimizer step) and no other kernel may
    launch."""
    cams, targets = ref[0], ref[1]
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(state, cams, targets)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = build.launch_counts()
    loss = float(out[1])
    parity = step_parity(loss, [getattr(state.model, f).grad
                                for f in ref[3]], ref)
    check(parity["ok"], f"{what}: loss {loss} vs unsharded {ref[2]} (rel "
          f"{parity['rel']:.2e}), gradients {parity['stats']}")
    check(counts == {**{k: 0 for k in counts}, "E-A": 2, "E-B": 2, "P": 2,
                     "P-bwd": 2, "bin": 2, "adam": 1},
          f"{what} on two views launched {counts}")
    return counts, step_ms, loss, parity


def phase_sharded(dev, cloud, cfg, frame, mesh, ref):
    """Phase 16, on the one-rank group: `render_sharded` equals `render`
    (phase 4's frame) bit for bit; one `make_sharded_train_step` step on
    two 1080p views against the unsharded loss and gradients → E's
    launches in that step."""
    camera = bench_camera(W, H, dev)
    build.reset_launches()
    with torch.no_grad():
        rgb, alpha = render_sharded(cloud, camera, W, H, mesh, cfg)
    torch.cuda.synchronize()
    render_counts = build.launch_counts()
    check(torch.equal(rgb, frame), "render_sharded on one rank "
          "differs from render")
    check(render_counts == {**{k: 0 for k in render_counts}, "E-A": 1,
                            "P": 1, "bin": 1},
          f"render_sharded launched {render_counts}")
    model = GaussianModel.from_cloud(cloud)
    state = TrainState(model, make_optimizer(model))
    counts, step_ms, loss, parity = sharded_step_check(
        make_sharded_train_step(W, H, mesh, cfg), state, ref, "sharded step")
    rel, stats, equal = parity["rel"], parity["stats"], parity["bitwise"]
    print(f"[16 sharded] one-rank NCCL mesh {mesh.shape}: render_sharded "
          f"equal to render bit for bit (launches "
          + " ".join(f"{k}={v}" for k, v in render_counts.items() if v)
          + f"); one sharded step on two {W}x{H} views: loss "
          f"{loss:.6f} vs unsharded {ref[2]:.6f} (rel "
          f"{rel:.2e}), gradients p99 {stats['p99']:.2e}, "
          f"{'equal bit for bit' if equal else 'not bitwise equal'}; "
          "launches " + " ".join(f"{k}={v}" for k, v in counts.items() if v)
          + f"; step {step_ms:.1f} ms (host clock, one step)")
    return counts


def phase_gaussian_sharded(dev, cloud, cfg, frame, mesh, ref):
    """Phase 18, on the one-rank group: the Gaussian-sharded ring render
    and the banded renders (a2a and ring streams) equal `render` (phase
    4's frame) bit for bit with overflow 0, one E-A and one P launch each;
    one ring, one banded a2a and one banded ring-stream step of
    `make_gaussian_sharded_train_step` on two 1080p views against the
    unsharded loss and gradients, E-A, E-B, P and P-bwd 2 each; the dry run
    in the group."""
    camera = bench_camera(W, H, dev)
    shard = shard_model(cloud, mesh)

    def run(name):
        if name == "ring":
            rgb, alpha = render_gaussian_sharded(shard, camera, W, H, mesh,
                                                 cfg)
            return rgb, 0
        rgb, _, over = render_gaussian_sharded_banded(
            shard, camera, W, H, mesh, cfg, stream=name.split()[1])
        return rgb, int(over)

    renders = []
    for name in ("ring", "banded a2a", "banded ring"):
        build.reset_launches()
        rgb, over = run(name)
        torch.cuda.synchronize()
        counts = build.launch_counts()
        check(torch.equal(rgb, frame), f"Gaussian-sharded {name} render on "
              "one rank differs from render")
        check(over == 0, f"Gaussian-sharded {name} render: overflow {over}")
        check(counts == {**{k: 0 for k in counts}, "E-A": 1, "P": 1,
                         "bin": 1},
              f"Gaussian-sharded {name} render launched {counts}")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(name)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        renders.append(f"{name} {statistics.median(times):.2f}")
    # the selection stage alone (S = 1: one band, cap_hop = N)
    gy = cfg.grid_size(W, H)[1]
    with torch.no_grad():
        splats = project_gaussians(shard, camera, W, H, cfg)
        select_ms = {}
        for name, select in (("a2a", banded_candidates_a2a),
                             ("ring", banded_candidates)):
            times = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                select(splats, W, H, mesh, banded_tile_rows(gy, 1),
                       banded_cap_hop(cloud.num_gaussians, 1, 2.5), cfg)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            select_ms[name] = statistics.median(times[1:])
        del splats
    steps = []
    for name, banded, stream in (("ring", False, "a2a"),
                                 ("banded a2a", True, "a2a"),
                                 ("banded ring", True, "ring")):
        state = init_sharded_train_state(GaussianModel.from_cloud(cloud),
                                         mesh)
        step = make_gaussian_sharded_train_step(W, H, mesh, cfg,
                                                banded=banded, stream=stream)
        counts, step_ms, loss, parity = sharded_step_check(
            step, state, ref, f"Gaussian-sharded {name} step")
        rel, stats, equal = (parity["rel"], parity["stats"],
                             parity["bitwise"])
        steps.append(f"{name}: loss {loss:.6f} (rel {rel:.2e}), gradients "
                     f"p99 {stats['p99']:.2e}, "
                     f"{'equal bit for bit' if equal else 'not bitwise equal'}"
                     f", launches " + " ".join(
                         f"{k}={v}" for k, v in counts.items() if v)
                     + f", step {step_ms:.1f} ms")
        del state, step
    losses = dryrun_multichip(1)
    check(all(math.isfinite(v) for v in losses.values()),
          f"dryrun_multichip(1) losses {losses}")
    print(f"[18 gsharded] one-rank NCCL mesh {mesh.shape}, "
          f"{cloud.num_gaussians} splats at {W}x{H}: renders equal to "
          "render bit for bit, overflow 0, one E-A and one P launch each "
          "(host clock, "
          "medians of 3 in ms: " + ", ".join(renders)
          + "; the banded selection alone "
          + ", ".join(f"{k} {v:.2f}" for k, v in select_ms.items())
          + f"); one step on two views vs unsharded {ref[2]:.6f}: "
          + "; ".join(steps) + " (host clock, one step each); "
          "dryrun_multichip(1): " + ", ".join(
              f"{k} {v:.5f}" for k, v in losses.items()))


def phase_config(dev, cloud, cfg, frame):
    """Phase 19: `debug_selected` and bf16 storage on the card. The
    highlight of a splat near the frame's centre through kernel A (`render`
    and `rasterize_tiles`) against the plain twin on the same highlighted
    fields, by the image rule; a `dtype="bfloat16"` render against the
    twin on the same bf16 inputs (the image rule) and against phase 4's f32
    frame within JAX tests/test_rasterize.py:155-176's bounds (mean |diff|
    < 5e-3, p99 < 0.05)."""
    camera = bench_camera(W, H, dev)
    with torch.no_grad():
        splats = project_gaussians(cloud, camera, W, H, cfg)
        bins = bin_splats(splats, W, H, cfg)
        dist_c = (splats.mean2d - splats.mean2d.new_tensor([W / 2, H / 2])
                  ).norm(dim=-1)
        pick = splats.valid & (splats.radius >= 8) & (splats.radius <= 64)
        check(bool(pick.any()), "no splat of radius 8-64 px to highlight")
        k = int(torch.where(pick, dist_c, float("inf")).argmin())
        cfg_d = cfg.replace(debug_selected=k)
        build.reset_launches()
        img_d, _ = render(cloud, camera, W, H, cfg_d)
        got = rasterize_tiles(splats, bins, W, H, cfg_d)
        counts = build.launch_counts()
        check(counts == {**{c: 0 for c in counts}, "A": 2, "P": 1,
                         "bin": 1},
              f"debug_selected renders launched {counts}")
        check(torch.equal(img_d, got.rgb), "debug_selected: render and "
              "rasterize_tiles differ")
        fields = rasterize.highlight_selected(pack_splat_fields(splats),
                                              cfg_d)
        want = composite_image_plain(fields, bins, W, H, cfg_d)
        err_d = compare(got, want, "debug_selected")
        changed = int(((img_d - frame).abs().amax(-1) > 1e-3).sum())
        check(changed > 0, "debug_selected changed no pixel")

        bf = cloud.with_storage_dtype("bfloat16")
        cfg_b = cfg.replace(dtype="bfloat16")
        build.reset_launches()
        img_b, aux_b = render(cloud, camera, W, H, cfg_b)
        counts_b = build.launch_counts()
        check(counts_b == {**{c: 0 for c in counts_b}, "A": 1, "P": 1,
                           "bin": 1},
              f"bf16 render launched {counts_b}")
        splats_b = project_gaussians(bf, camera, W, H, cfg)
        bins_b = bin_splats(splats_b, W, H, cfg)
        fields_b = pack_splat_fields(splats_b)
        err_b = compare(raster_cuda.composite_image(fields_b, bins_b, W, H,
                                                    cfg),
                        composite_image_plain(fields_b, bins_b, W, H, cfg),
                        "bf16 storage")
        check(torch.equal(img_b, raster_cuda.composite_image(
            fields_b, bins_b, W, H, cfg).rgb), "bf16: render differs from "
              "the kernel on the pre-converted cloud")
        diff = (img_b - frame).abs()
        mean, p99 = float(diff.mean()), float(torch.quantile(
            diff.reshape(-1), 0.99))
        check(mean < 5e-3 and p99 < 0.05,
              f"bf16 frame off the f32 frame: mean {mean:.2e}, p99 {p99:.2e}")
    print(f"[19 config] debug_selected={k} (radius "
          f"{float(splats.radius[k]):.0f} px) through A vs its twin: max "
          f"abs err {err_d['max_abs_err']:.3e}, {changed} pixels changed; "
          f"dtype=bfloat16 through A vs its twin on the bf16 inputs: max abs "
          f"err {err_b['max_abs_err']:.3e}; vs the f32 frame mean |diff| "
          f"{mean:.2e}, p99 {p99:.2e} (bound 5e-3, 0.05); launches A=2 P=1 "
          "bin=1 and A=1 P=1 bin=1")


def phase_packed(dev, cloud, frame, exact):
    """Phase 20: the packed and tiered modes on the 1M scene at 1080p.
    The bins of CFG_P, CFG_CULL and CFG_AP against the JAX package's CPU
    figures; kernels A, B, E-A and E-B with the mean16 flag (and the tiered
    pack_grads fold) and C and D on packed anchor bins against their twins
    on the small scenes and at 1080p (phases 2, 3, 15, 10, 11 rerun, 0
    culled passing steps); `render` and a fwd+bwd step in each mode with
    their launches, the frame against phase 4's exact-mode frame within
    phase 19's bf16 bounds; per-stage, step, fold and kernel times beside
    the exact mode's from `exact` (phases 2-5, 12, 13 of this run)."""
    camera = bench_camera(W, H, dev)
    counts = {}
    with torch.no_grad():
        splats = project_gaussians(cloud, camera, W, H, CFG_P)
        for name, cfg, want in (
                ("packed", CFG_P, (PACKED_PAIRS, PACKED_OVERFLOW,
                                   PACKED_MAX_TILE)),
                ("packed+cull", CFG_CULL, (CULL_PAIRS, CULL_OVERFLOW,
                                           CULL_MAX_TILE))):
            bins = bin_splats(splats, W, H, cfg)
            got = (int(bins.num_pairs), int(bins.overflow),
                   int(bins.tile_count.max()))
            slots = bins.sorted_slot.shape[0]
            cap = min(slots, max(int(N_SCENE * cfg.gather_cap_factor),
                                 cfg.gather_cap_floor))
            check(slots == PACKED_SLOTS and cap == PACKED_PAIR_CAP,
                  f"{name}: {slots} slots, pair cap {cap}")
            check(abs(got[0] - want[0]) <= 1e-3 * want[0]
                  and abs(got[1] - want[1]) <= 5
                  and abs(got[2] - want[2]) <= 2,
                  f"{name}: (pairs, overflow, max tile) {got} vs CPU {want}")
            counts[name] = got + (slots, cap, slots * 36)
            if name == "packed":
                # the sort alone: the live pairs' packed keys (in a random
                # order) as the port sorts them, int64, against the same
                # keys offset into int32, which is all the packed key needs
                bits = sort_key_bits(cfg.num_tiles(W, H), cfg)
                tile = torch.repeat_interleave(
                    torch.arange(cfg.num_tiles(W, H), device=dev),
                    bins.tile_count.long())
                dkey = float_to_sortable_uint(
                    splats.depth[bins.sorted_gidx.long()]) >> (32 - bits)
                gen = torch.Generator(device=dev).manual_seed(0)
                key64 = ((tile << bits) | dkey)[torch.randperm(
                    tile.shape[0], generator=gen, device=dev)]
                key32 = (key64 - (1 << 31)).to(torch.int32)
                sort_ms = (
                    median_ms(lambda: torch.sort(key64, stable=True), 7),
                    median_ms(lambda: torch.sort(key32, stable=True), 7))
        abins = anchor.bin_splats_anchor(splats, W, H, CFG_AP)
        got = (int(abins.num_pairs), int(abins.overflow))
        check(abs(got[0] - ANCHOR_PACKED_PAIRS) <= 1e-3 * ANCHOR_PACKED_PAIRS
              and abs(got[1] - ANCHOR_PACKED_OVERFLOW) <= 5,
              f"packed anchor: (pairs, overflow) {got} vs CPU "
              f"{(ANCHOR_PACKED_PAIRS, ANCHOR_PACKED_OVERFLOW)}")
        check(int(abins.sorted_depth.max()) <= 0xFFFF, "packed anchor: the "
              "sorted depths are not d16 keys")
        counts["packed anchor"] = got
        del splats, bins, abins
        print("[20 packed] bins at 1080p vs the JAX package's CPU run: "
              + "; ".join(
                  f"{k}: num_pairs {v[0]}, overflow {v[1]}"
                  + (f", max tile {v[2]}, slots {v[3]}, pair cap {v[4]}, "
                     f"fold buffer {v[5]} bytes" if len(v) > 2 else "")
                  for k, v in counts.items())
              + f" (CPU: {PACKED_PAIRS}/{PACKED_OVERFLOW}, {CULL_PAIRS}/"
              f"{CULL_OVERFLOW}, {ANCHOR_PACKED_PAIRS}/"
              f"{ANCHOR_PACKED_OVERFLOW}; exact-mode slots {N_SCENE * 16}, "
              f"fold buffer {N_SCENE * 16 * 36} bytes); the {PACKED_PAIRS} "
              f"packed keys' stable sort: int64 {sort_ms[0]:.3f} ms, the "
              f"same keys as int32 {sort_ms[1]:.3f} ms")

        fwd, full = phase_kernel(dev, cloud, CFG_P, label="20 packed A")
        bwd = phase_backward(dev, CFG_P, full, label="20 packed B")
        tiles = phase_tiles(dev, CFG_P, full, label="20 packed E")
        del full
        afwd, afull = phase_anchor_kernel(dev, cloud, CFG_AP,
                                          label="20 packed C")
        abwd = phase_anchor_backward(dev, CFG_AP, afull, label="20 packed D")
        del afull
        modes = {}
        for name, cfg, expect in (
                ("packed", CFG_P, (PACKED_PAIRS, PACKED_OVERFLOW)),
                ("packed+cull", CFG_CULL, (CULL_PAIRS, CULL_OVERFLOW)),
                ("packed anchor", CFG_AP, (ANCHOR_PACKED_PAIRS,
                                           ANCHOR_PACKED_OVERFLOW))):
            img, med = phase_render(dev, cloud, cfg, label=f"20 {name}",
                                    expect=expect)
            diff = (img - frame).abs()
            mean = float(diff.mean())
            p99 = float(torch.quantile(diff.reshape(-1), 0.99))
            check(mean < 5e-3 and p99 < 0.05, f"{name}: frame off the exact "
                  f"frame: mean {mean:.2e}, p99 {p99:.2e}")
            modes[name] = {"med": med, "mean": mean, "p99": p99}
    for name, cfg in (("packed", CFG_P), ("packed+cull", CFG_CULL),
                      ("packed anchor", CFG_AP)):
        modes[name]["step"] = phase_step(
            dev, cloud, cfg, label=f"20 {name}",
            kernels="CD" if cfg.binning == "anchor" else "AB")

    def stages(med):
        return "/".join(f"{med[k]:.2f}" for k in ("projection", "binning",
                                                  "composite", "frame"))

    print("[20 packed] against the exact mode of this run: "
          + "; ".join(
              f"{k}: frame vs exact mean |diff| {v['mean']:.2e}, p99 "
              f"{v['p99']:.2e} (bound 5e-3, 0.05); projection/binning/"
              f"composite/frame medians {stages(v['med'])} ms (exact "
              f"{stages(exact['anchor' if 'anchor' in k else 'dup'])}); "
              f"fwd+bwd step {v['step']:.2f} ms (exact "
              f"{exact['step_a' if 'anchor' in k else 'step']:.2f})"
              for k, v in modes.items())
          + f"; kernel only with mean16: A {fwd['ms']:.3f} ms (exact "
          f"{exact['A']['ms']:.3f}), B {bwd['ms']:.3f} (exact "
          f"{exact['B']['ms']:.3f}), E-A "
          f"{tiles['raster_fwd_tiles']['ms']:.3f} (exact "
          f"{exact['E']['raster_fwd_tiles']['ms']:.3f}), E-B "
          f"{tiles['raster_bwd_tiles']['ms']:.3f} (exact "
          f"{exact['E']['raster_bwd_tiles']['ms']:.3f}); on packed anchor "
          f"bins C {afwd['ms']:.3f} (exact {exact['C']['ms']:.3f}), D "
          f"{abwd['ms']:.3f} (exact {exact['D']['ms']:.3f}); fold tiered "
          f"with pack_grads {bwd['fold_ms']:.3f} ms over "
          f"{counts['packed'][5]} bytes (exact {exact['B']['fold_ms']:.3f} "
          f"ms over {N_SCENE * 16 * 36}), packed anchor fold "
          f"{abwd['fold_ms']:.3f} ms (exact {exact['D']['fold_ms']:.3f}); "
          f"bounds A {fwd['bound_ms']:.4f}, B {bwd['bound_ms']:.4f}, C "
          f"{afwd['bound_ms']:.4f}, D {abwd['bound_ms']:.4f} ms; plain A "
          f"{fwd['plain_ms']:.3f}, B {bwd['plain_ms']:.3f}, C "
          f"{afwd['plain_ms']:.3f}, D {abwd['plain_ms']:.3f} ms")


def mutant_gate(cloud, camera, w, h, scale):
    """`bench_lib._grad_parity` with the kernel path's gradient scaled by
    `scale` → its stats."""
    real = bench_lib._kernel_grads

    def scaled(*args):
        loss, grads = real(*args)
        return loss, [g * scale for g in grads]

    bench_lib._kernel_grads = scaled
    try:
        return bench_lib._grad_parity(cloud, camera, w, h, RenderConfig())
    finally:
        bench_lib._kernel_grads = real


def phase_bench(dev, cloud):
    """Phase 21: the bench on the card, its gate and the gate's mutant,
    `cli bench` at 720p, and the native PLY read against the NumPy one.
    The bench's forward median is held against phase 4's frame timing
    taken again just before it: the host's speed drifts between phases a
    minute apart (on one H100, phase 4's median read 8.7-12.5 ms across
    runs of one tree), and a 2.5-ms frame, much of it host time, swings by
    up to a fifth from call to call, so both medians take 20 frames."""
    with torch.no_grad():
        frame_ms = statistics.median(timed_frames(
            cloud, bench_camera(W, H, dev), RenderConfig(), 20)[3])
    result = bench_lib.run(emit_json=False)
    check(result["parity_gate_ok"] is True,
          f"bench: the gradient-parity gate is not green: {result}")
    pairs, over = result["live_pairs"], result["overflow"]
    check(abs(pairs - CPU_PAIRS) <= 1e-3 * CPU_PAIRS
          and abs(over - CPU_OVERFLOW) <= 5,
          f"bench: live pairs {pairs}, overflow {over} vs CPU "
          f"{CPU_PAIRS}, {CPU_OVERFLOW}")
    shares = {"forward": result["pct_roofline_forward"],
              "fwd+bwd": result["pct_roofline_fwd_bwd"],
              **{k: v["pct_roofline"] for k, v in result["roofline"].items()}}
    check(all(0 < v <= 100 for v in shares.values()),
          f"bench: roofline shares outside (0, 100]: {shares}")
    off = abs(result["forward_ms"] - frame_ms) / frame_ms
    check(off <= 0.25, f"bench: forward median {result['forward_ms']:.3f} "
          f"ms vs phase 4's frame timing, median {frame_ms:.3f} ms")
    print(f"[21 bench] frame timed as in phase 4, just before run(): "
          f"median {frame_ms:.3f} ms; run(): {json.dumps(result)}")

    # the gate with the kernel path's gradient scaled: x1.01 at 1M splats
    # and 1080p is printed (its p99 is 0.01 x the p99 of |g| / max|g|,
    # below the 1e-3 limit there); x1.1 there and x1.01 on 20,000 splats
    # at 320x240 must turn it red
    small = make_scene(20_000, device=dev)
    mutants = {name: mutant_gate(scene, bench_camera(w, h, dev), w, h, k)
               for name, scene, w, h, k in (
                   ("x1.01 1080p", cloud, W, H, 1.01),
                   ("x1.1 1080p", cloud, W, H, 1.1),
                   ("x1.01 320x240", small, 320, 240, 1.01))}
    for name in ("x1.1 1080p", "x1.01 320x240"):
        check(not mutants[name]["ok"], f"bench: the gate stays green with "
              f"the kernel path's gradient {name}: {mutants[name]}")

    proc, dt = run_cli(["bench", "--width", "1280", "--height", "720"],
                       "bench")
    lines = proc.stdout.strip().splitlines()
    check(len(lines) == 1, f"cli bench printed {lines}")
    line = json.loads(lines[0])
    check(line["parity_gate_ok"] is True and line["metric"]
          == "forward_render_720p", f"cli bench printed {lines[0]}")

    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "scene1m.ply")
        write_ply(cloud, ply)
        reads, times = {}, {}
        for native in (True, False):
            t = []
            for _ in range(3):
                t0 = time.perf_counter()
                reads[native] = read_ply(ply, device="cpu",
                                         use_native=native)
                t.append((time.perf_counter() - t0) * 1e3)
            times[native] = statistics.median(t)
        size = os.path.getsize(ply)
    for f in ("xyz", "log_scale", "quat", "opacity_logit", "sh"):
        check(torch.equal(getattr(reads[True], f), getattr(reads[False], f)),
              f"native PLY read: {f} differs from the NumPy read")
    print("[21 bench] the gate with the kernel path's gradient scaled: "
          + "; ".join(f"{k}: p99 {v['p99']:.2e}, max {v['max']:.2e}, >1% "
                      f"{v['nbig']}/{v['n']}, "
                      f"{'green' if v['ok'] else 'red'}"
                      for k, v in mutants.items())
          + f"; cli bench 1280x720: {lines[0]}; process {dt:.1f} s; read_ply "
          f"of the {N_SCENE}-splat PLY ({size} bytes), native and NumPy "
          f"equal bit for bit: native {times[True]:.1f} ms, NumPy "
          f"{times[False]:.1f} ms (host clock, medians of 3)")


def phase_eval(capture):
    """Phase 17: `cli eval --device cuda` on phase 8's views and trained
    PLY prints its JSON line with a finite PSNR."""
    cams, images, ply = capture
    proc, dt = run_cli(["eval", "--ply", ply, "--cameras", cams, "--images",
                        images, "--width", str(W), "--height", str(H),
                        "--device", "cuda"], "eval")
    line = proc.stdout.strip().splitlines()[-1]
    got = json.loads(line)
    check(got["views"] == 4 and math.isfinite(got["psnr_mean"])
          and math.isfinite(got["ssim_mean"]), f"cli eval printed {line}")
    print(f"[17 eval] cli eval --device cuda on phase 8's 4 views and "
          f"trained PLY: {line}; process {dt:.1f} s")


def crowded_scenes(dev):
    """2500 small splats over the central tiles of a 64x48 frame. Crowded:
    at the default caps some ranges overrun their 1,536-position cover and
    some tiles hold more than k_cap = 1024 touched candidates. Column
    overrun: spread wider, so that a range A splits its columns past its
    cover while range B holds candidates below that split."""
    out = []
    for what, seed, spread in (("crowded 64x48", 9, 0.15),
                               ("column overrun 64x48", 1, 0.25)):
        cloud = make_scene(2500, seed=seed, sh_degree=0,
                           log_scale_range=(-3.5, -1.5), device=dev)
        cloud.xyz = cloud.xyz * spread
        out.append((what, cloud, 64, 48, -6.0))
    return out


def anchor_binned(cloud, camera, w, h, cfg):
    splats = project_gaussians(cloud, camera, w, h, cfg)
    return pack_splat_fields(splats, cfg), anchor.bin_splats_anchor(
        splats, w, h, cfg)


def anchor_vs_plain(fields, abins, w, h, cfg, what):
    """Kernel C against its plain twin: identical ordered lists, lengths
    and row groups, the image rule, and the footprint cull's mirror over
    C's ordered lists (no culled step passes the cutoff)."""
    got, merge = anchor_cuda.composite_anchor(fields, abins, w, h, cfg)
    want, want_merge = anchor.composite_anchor_plain(fields, abins, w, h,
                                                     cfg)
    for name, a, b in zip(anchor.Merge._fields, merge, want_merge):
        check(torch.equal(a, b), f"{what}: kernel C's {name} differs from "
              "the plain merge")
    found = compare(got, want, what)
    view, vcfg = anchor.ordered_view(abins, merge, cfg)
    found["culled"] = cull_check(fields, view, w, h, vcfg, what)
    return found, got, merge


def phase_anchor_kernel(dev, cloud, cfg, label="10 anchor"):
    findings = {}
    half = anchor.c_max(cfg) * anchor.KCL
    kc = anchor.k_cap(cfg)
    for what, scene, w, h, z in small_scenes(dev) + crowded_scenes(dev):
        camera = default_camera(w, h, eye=(0, 0, z), center=(0, 0, 0)).to(dev)
        fields, abins = anchor_binned(scene, camera, w, h, cfg)
        findings[what], got, merge = anchor_vs_plain(fields, abins, w, h, cfg,
                                                     what)
        if what.startswith("crowded"):
            rng = anchor.tile_ranges(abins, *cfg.grid_size(w, h), cfg)
            check(int((rng.s1 - rng.base).max()) > half and
                  int(merge.k_used.max()) == kc,
                  "crowded scene: no cover overrun or no k_cap cut")
        if what.startswith("column"):
            check(bool(anchor.split_overruns(abins, *cfg.grid_size(w, h),
                                             cfg).any()),
                  "column overrun scene: no range A split past its cover "
                  "with range B candidates below the split")

    camera = bench_camera(W, H, dev)
    fields, abins = anchor_binned(cloud, camera, W, H, cfg)
    findings["1080p"], got, merge = anchor_vs_plain(fields, abins, W, H, cfg,
                                                    "1080p")
    gx, gy = cfg.grid_size(W, H)
    prepared = anchor_cuda.prepare_fwd(fields, abins, W, H, cfg)
    ms = kernel_ms(prepared)
    schedule_check(prepared[1][2],
                   *anchor_cuda.schedule_weight(abins, gx, gy, cfg),
                   "kernel C")
    wrapper_ms = median_ms(
        lambda: anchor_cuda.composite_anchor(fields, abins, W, H, cfg), 7)
    plain_ms = median_ms(
        lambda: anchor.composite_anchor_plain(fields, abins, W, H, cfg), 7,
        warmup=1)
    view, vcfg = anchor.ordered_view(abins, merge, cfg)
    steps = work(fields, view, got, W, H, vcfg)
    t = gx * gy
    union = int(anchor.cover_lengths(abins, gx, gy, cfg).sum())
    touched = int(anchor.touched_counts(abins, gx, gy, cfg).sum())
    kept = int(merge.k_used.sum())
    nbytes = (fields.numel() * 4 + (t + 1) * 4 + union + touched * 4
              + kept * 4 + H * W * 6 * 4 + t * kc * 5 + t * 4)
    bound_ms, bound_by, step_ms = bound("anchor_fwd", steps["A"], nbytes)
    print(f"[{label}] kernel C vs plain twin: "
          + "; ".join(f"{k}: max_abs_err {v['max_abs_err']:.3e}, "
                      f">{ATOL} on {v['bad_frac']:.2e}, "
                      f"log-T err {v['log_t_err']:.2e}, "
                      f"last-idx diff {v['last_idx_frac']:.2e}, "
                      f"culled {v['culled']:.4f} of the steps, 0 passing"
                      for k, v in findings.items())
          + f"; ordered lists identical; schedule heavy first; 1080p kernel "
          f"{ms:.3f} ms, wrapper {wrapper_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms; union positions "
          f"read {union}, touched {touched}, kept pairs {kept}; "
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
    g_got = anchor.fold_anchor_grads(got, abins, n, cfg)
    g_want = anchor.fold_anchor_grads(want, abins, n, cfg)
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite D output")
    check(g_want.abs().max().item() > 0, f"{what}: zero gradients")
    stats = grad_parity(g_got.T, g_want.T)
    stats["max_abs_err"] = (g_got - g_want).abs().max().item()
    check(grad_parity_ok(stats, GRAD_EXTRA),
          f"{what}: kernel D vs twin outside the gradient rule: {stats}")
    return stats, (d_rgb, d_alpha, got)


def phase_anchor_backward(dev, cfg, full, label="11 anchor"):
    findings = {}
    for what, scene, w, h, z in small_scenes(dev) + crowded_scenes(dev):
        camera = default_camera(w, h, eye=(0, 0, z), center=(0, 0, 0)).to(dev)
        fields, abins = anchor_binned(scene, camera, w, h, cfg)
        fwd, merge = anchor_cuda.composite_anchor(fields, abins, w, h, cfg)
        findings[what], _ = anchor_backward_vs_plain(fields, abins, fwd,
                                                     merge, w, h, cfg, what)
    fields, abins, fwd, merge, steps = full
    stats, (d_rgb, d_alpha, dpairs) = anchor_backward_vs_plain(
        fields, abins, fwd, merge, W, H, cfg, "1080p")
    findings["1080p"] = stats
    prepared = anchor_cuda.prepare_bwd(fields, abins, W, H, cfg, fwd, merge,
                                       d_rgb, d_alpha)
    ms = kernel_ms(prepared)
    schedule_check(prepared[1][1], merge.k_used, anchor.k_cap(cfg),
                   "kernel D")
    wrapper_ms = median_ms(lambda: anchor_cuda.composite_anchor_backward(
        fields, abins, W, H, cfg, fwd, merge, d_rgb, d_alpha), 7)
    plain_ms = median_ms(lambda: anchor.composite_anchor_backward_plain(
        fields, abins, W, H, cfg, fwd, d_rgb, d_alpha), 7, warmup=1)
    n = fields.shape[0]
    fold_ms = median_ms(
        lambda: anchor.fold_anchor_grads(dpairs, abins, n, cfg), 7)
    t = cfg.num_tiles(W, H)
    kept = int(merge.k_used.sum())
    nbytes = (fields.numel() * 4 + kept * (4 + 4 + 1) + t * 4
              + H * W * 6 * 4 + kept * 36)
    bound_ms, bound_by, step_ms = bound("anchor_bwd", steps["B"], nbytes)
    print(f"[{label}] kernel D vs plain twin after the fold, bitwise "
          "repeatable on each scene: "
          + "; ".join(f"{k}: p99 {v['p99']:.2e}, max {v['max']:.2e}, "
                      f">1% {v['nbig']}/{v['n']}, "
                      f"max_abs_err {v['max_abs_err']:.3e}"
                      for k, v in findings.items())
          + f"; schedule heavy first; 1080p kernel {ms:.3f} ms, wrapper "
          f"{wrapper_ms:.3f} ms, plain {plain_ms:.3f} ms, fold "
          f"{fold_ms:.3f} ms; "
          + work_line(steps["B"], nbytes, bound_ms, bound_by, step_ms,
                      "contributing"))
    return {"max_abs_err": findings["1080p"]["max_abs_err"], "ms": ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "fold_ms": fold_ms}


def timed_frames(cloud, camera, cfg, frames):
    """`render` + `post_process` at W x H, each frame between synchronizes
    on the host clock → (img, aux, rgba of the last, ms per frame)."""
    times = []
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, aux = render(cloud, camera, W, H, cfg)
        rgba = post_process(img, aux["alpha"], cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return img, aux, rgba, times


def phase_render(dev, cloud, cfg, frames=5, ref=None, label=None,
                 expect=None):
    """`render` for a few frames with cfg's binning; `ref` is the dup
    path's frame to hold an anchor frame against (printed only); `expect`
    the JAX package's (pairs, overflow) for cfg → (frame, stage medians)."""
    is_anchor = cfg.binning == "anchor"
    kernel = "C" if is_anchor else "A"
    label = label or ("12 anchor" if is_anchor else "4 render")
    pairs, over = expect or ((ANCHOR_PAIRS, ANCHOR_OVERFLOW) if is_anchor
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
                    pack_splat_fields(splats, cfg), bins, W, H, cfg)
            else:
                rasterize_tiles(splats, bins, W, H, cfg)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            stages["projection"].append((t1 - t0) * 1e3)
            stages["binning"].append((t2 - t1) * 1e3)
            stages["composite"].append((t3 - t2) * 1e3)

        build.reset_launches()
        img, aux, rgba, stages["frame"] = timed_frames(cloud, camera, cfg,
                                                       frames)
        counts = build.launch_counts()
    check(counts == {k: frames * (k in (kernel, "P",
                                        *binned_by_kernels(cfg, kernel)))
                     for k in counts},
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
    if is_anchor and ref is not None:
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
    return img, med


def phase_project(dev, cloud, cfg, label="22 project"):
    """P fwd and P bwd at 1080p on the 1M scene against their twins, timed
    alone → (P fwd, P bwd) results for the JSON line."""
    n = cloud.num_gaussians
    check(cloud.sh.shape[1] == 16, "the byte floors are SH degree 3's")
    camera = bench_camera(W, H, dev)
    build.reset_launches()
    with torch.no_grad():
        got = project_gaussians(cloud, camera, W, H, cfg)
        want = project_gaussians_plain(cloud, camera, W, H, cfg)
    fwd = projection_parity(got, want, W, H, cfg)
    check(fwd["ok"] and fwd["excused"] <= 1e-4 * n, f"P fwd vs twin: {fwd}")
    visible = int(want.valid.sum())
    del got, want
    host = type(cloud)(**{f: getattr(cloud, f).cpu() for f in PROJ_INPUTS})
    grads = projection_grads_vs_f64(host, bench_camera(W, H, "cpu"), W, H,
                                    cfg, dev, seed=0)
    bwd = projection_grad_parity(*grads)
    check(bwd["ok"], f"P bwd vs float64 autograd: {bwd}")
    del host, grads
    counts = build.launch_counts()
    check(counts == {**{k: 0 for k in counts}, "P": 2, "P-bwd": 1},
          f"the projection's checks launched {counts}")

    ins = project_cuda._inputs(*(getattr(cloud, f) for f in PROJ_INPUTS))
    cam = pack_camera(camera)
    run_f, splats = project_cuda.prepare_fwd(ins, cam, W, H, cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    d_out = [None if f == "depth" else
             torch.randn(getattr(splats, f).shape, generator=gen, device=dev)
             for f in ("mean2d", "conic", "depth", "rgb", "opacity")]
    run_b, _ = project_cuda.prepare_bwd(ins, cam, d_out, W, H, cfg)
    results = []
    for name, run, plain, nbytes, err in (
            ("P fwd", run_f,
             lambda: project_gaussians_plain(cloud, camera, W, H, cfg),
             P_FWD_BYTES, fwd["max_abs_err"]),
            ("P bwd", run_b,
             lambda: project_backward_plain(*ins, cam, W, H, cfg, *d_out),
             P_BWD_BYTES, bwd["max_abs_err"])):
        ms = kernel_ms((run,))
        bound_ms = 1e3 * n * nbytes / HBM_BYTES_S
        results.append({"max_abs_err": err, "ms": ms,
                        "plain_ms": median_ms(plain, 7, warmup=1),
                        "bound_ms": bound_ms, "bound_by": "bytes",
                        "library_ms": None, "name": name, "bytes": nbytes})
    print(f"[{label}] P fwd vs twin at {W}x{H} on {n} splats ({visible} "
          "visible): largest error / tolerance "
          + ", ".join(f"{k} {v:.3f}" for k, v in fwd["fields"].items())
          + f", {fwd['excused']} rows excused; P bwd vs float64 autograd, "
          "largest / median row error "
          + ", ".join(f"{k} {a:.2e}/{b:.2e}"
                      for k, (a, b) in bwd["leaves"].items())
          + f", {bwd['switch']} rows on a switch point; launches P=2 "
          "P-bwd=1; kernel alone "
          + "; ".join(f"{r['name']} {r['ms']:.4f} ms ({r['bytes']} B a "
                      f"splat: {100 * r['bound_ms'] / r['ms']:.1f}% of the "
                      f"byte floor {r['bound_ms']:.4f} ms), twin "
                      f"{r['plain_ms']:.3f} ms" for r in results))
    return tuple({k: v for k, v in r.items() if k not in ("name", "bytes")}
                 for r in results)


def count_syncs(fn):
    """fn() with the synchronising CUDA calls it makes counted
    (`torch.cuda.set_sync_debug_mode`'s warnings, but for its warning that
    the mode is a prototype) → (result, count)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("called a synchronizing" in str(c.message)
                    for c in caught)


def phase_binning(dev, label="23 binning"):
    """`bin_splats` through csrc/bin.cu against `bin_splats_plain` on the
    same splats at BIN_SCENES: equal bit for bit, one launch and one host
    sync a call; both timed whole → the 1080p result for the JSON line."""
    cfg = RenderConfig()
    results, parts = [], []
    for n, w, h in BIN_SCENES:
        cloud = make_scene(n, seed=0, sh_degree=0, device=dev)
        camera = bench_camera(w, h, dev)
        with torch.no_grad():
            splats = project_gaussians(cloud, camera, w, h, cfg)
        torch.cuda.synchronize()
        build.reset_launches()
        got, syncs = count_syncs(lambda: bin_splats(splats, w, h, cfg))
        counts = build.launch_counts()
        check(counts == {**{k: 0 for k in counts}, "bin": 1},
              f"binning at {n} launched {counts}")
        check(syncs == 1, f"binning at {n} made {syncs} host syncs")
        want = bin_splats_plain(splats, w, h, cfg)
        for f in BIN_FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            check(a.dtype == b.dtype and torch.equal(a, b),
                  f"binning at {n}: {f} differs from the PyTorch path")
        ms = median_ms(lambda: bin_splats(splats, w, h, cfg), 7)
        plain_ms = median_ms(lambda: bin_splats_plain(splats, w, h, cfg), 7)
        kept, slots = int(got.num_pairs), got.sorted_slot.shape[0]
        gx, gy = cfg.grid_size(w, h)
        nbytes = binning_bytes(n, slots, kept, gx * gy)
        bound_ms = 1e3 * nbytes / HBM_BYTES_S
        parts.append(f"{n} at {w}x{h}: {kept} of {slots} slots live, "
                     f"kernels {ms:.3f} ms ({100 * bound_ms / ms:.1f}% of "
                     f"the byte floor {bound_ms:.4f} ms, {nbytes} B), "
                     f"PyTorch path {plain_ms:.3f} ms")
        results.append({"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": "bytes",
                        "library_ms": None})
        del cloud, splats, got, want
    print(f"[{label}] bin_splats (csrc/bin.cu) equal to bin_splats_plain "
          "bit for bit, every field; bin=1 and one host sync a call; "
          "whole calls (CUDA events, median of 7): " + "; ".join(parts))
    return results[-1]


def phase_adam(dev, label="24 adam"):
    """csrc/adam.cu over the six leaves at ADAM_ROWS: one step against
    `adam_plain` from the same state, one launch a `step()`; the kernel
    alone, the whole step, the twin and torch's foreach Adam timed → the
    `mipnerf360` result for the JSON line."""
    results, parts = [], []
    for n in ADAM_ROWS:
        gen = torch.Generator(device=dev).manual_seed(n)
        params = [torch.nn.Parameter(torch.randn((n, *s), generator=gen,
                                                 device=dev))
                  for s in ADAM_SHAPES]
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen, device=dev) * 1e-3
        lrs = (1.6e-4, 5e-3, 1e-3, 0.05, 2.5e-3, 1.25e-4)
        opt = adam_cuda.Adam([{"params": [p], "lr": lr}
                              for p, lr in zip(params, lrs)], eps=1e-15)
        opt.step()                                  # the moments exist
        leaves = []
        for p, lr in zip(params, lrs):
            st = opt.state[p]
            leaves.append(adam_cuda.Leaf(
                p.detach().clone(), p.grad, st["exp_avg"].clone(),
                st["exp_avg_sq"].clone(), lr / (1 - 0.9 ** 2),
                (1 - 0.999 ** 2) ** 0.5, 0.9, 0.999, 1e-15))
        old = [(x.p.clone(), x.m.clone(), x.v.clone()) for x in leaves]
        adam_cuda.adam_plain(leaves)
        build.reset_launches()
        opt.step()
        torch.cuda.synchronize()
        counts = build.launch_counts()
        check(counts == {**{k: 0 for k in counts}, "adam": 1},
              f"Adam.step() at {n} rows launched {counts}")
        gap, err = 0.0, 0.0
        for p, x, o in zip(params, leaves, old):
            st = opt.state[p]
            for a, b, prev in ((p.detach(), x.p, o[0]),
                               (st["exp_avg"], x.m, o[1]),
                               (st["exp_avg_sq"], x.v, o[2])):
                check(bool(torch.isfinite(a).all()), f"adam at {n}: "
                      "non-finite state")
                gap = max(gap, adam_ulp_gap(a, b, prev))
                err = max(err, float((a - b).abs().max()))
        check(gap <= ADAM_ULPS,
              f"adam at {n} rows: {gap:.2f} ulp off adam_plain")
        del old
        run = [adam_cuda.Leaf(p.detach(), p.grad, opt.state[p]["exp_avg"],
                              opt.state[p]["exp_avg_sq"], lr, 1.0, 0.9,
                              0.999, 1e-15) for p, lr in zip(params, lrs)]
        ms = median_ms(lambda: adam_cuda.adam_cuda(run), 7, repeat=5)
        step_ms = median_ms(opt.step, 7, repeat=5)
        plain_ms = median_ms(lambda: adam_cuda.adam_plain(leaves), 7)
        del leaves, run
        lib = torch.optim.Adam([{"params": [p], "lr": lr}
                                for p, lr in zip(params, lrs)], eps=1e-15,
                               foreach=True)
        library_ms = median_ms(lib.step, 7)
        del lib
        floats = n * ADAM_FLOATS
        bound_ms = 1e3 * floats * ADAM_BYTES / HBM_BYTES_S
        parts.append(f"{n} rows ({floats} floats): kernel {ms:.4f} ms "
                     f"({100 * bound_ms / ms:.1f}% of the {ADAM_BYTES}-B "
                     f"floor {bound_ms:.4f} ms), step() {step_ms:.4f} ms, "
                     f"adam_plain {plain_ms:.3f} ms, torch foreach Adam "
                     f"{library_ms:.3f} ms; {gap:.2f} ulp, max |diff| "
                     f"{err:.2e} off the twin")
        results.append({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": "bytes",
                        "library_ms": library_ms})
        del params, opt
        torch.cuda.empty_cache()
    print(f"[{label}] csrc/adam.cu, one launch a step() over six leaves "
          "(CUDA events, median of 7): " + "; ".join(parts))
    return results[0]


def phase_step(dev, cloud, cfg, steps=7, label="5 step", kernels="AB"):
    """Forward + backward through `render`, as a training step runs it;
    `kernels`, P and P-bwd launch once per step and no other does."""
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
    build.reset_launches()
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = build.launch_counts()
    check(counts == {k: steps * (k in (*kernels, "P", "P-bwd",
                                       *binned_by_kernels(cfg, kernels)))
                     for k in counts},
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
    build.reset_launches()
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
    counts = build.launch_counts()
    check(counts == {k: len(events) * (k in (
        kernel, "P", *binned_by_kernels(cfg, kernel))) for k in counts},
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


def write_capture(views, folder):
    """Views as INRIA writes a capture: PNGs and cameras.json → (cameras
    path, images folder)."""
    images = os.path.join(folder, "images")
    os.makedirs(images, exist_ok=True)
    entries = []
    for i, v in enumerate(views):
        write_png(v.image, os.path.join(images, f"{v.name}.png"))
        c = v.camera
        entries.append({
            "id": i, "img_name": v.name, "width": W, "height": H,
            "position": c.cam_pos.tolist(), "rotation": c.view[:3, :3].T.tolist(),
            "fx": float(c.focal[0]), "fy": float(c.focal[1])})
    cams = os.path.join(folder, "cameras.json")
    with open(cams, "w") as f:
        json.dump(entries, f)
    return cams, images


def phase_train(dev, cfg, iterations=30, label="8 train", kernels="AB",
                capture_dir=None):
    """`train()` on four 1080p views; with `capture_dir`, the views go
    there as a capture and the trained scene as trained.ply → (launches,
    (cameras path, images folder, PLY path) or None)."""
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

    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, dstate = train(model, views, W, H, render_config=cfg, loop=loop,
                          on_log=on_log, device=dev)
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    check(counts == {k: iterations * (k in (
        *kernels, "P", "P-bwd", "adam", *binned_by_kernels(cfg, kernels)))
        for k in counts},
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
    if capture_dir is None:
        return counts, None
    cams, images = write_capture(views, capture_dir)
    ply = os.path.join(capture_dir, "trained.ply")
    save_ply(compact(state.model, dstate), ply)
    return counts, (cams, images, ply)


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
        tiles = phase_tiles(dev, cfg, full)
        del full
        frame, med = phase_render(dev, cloud, cfg)
        afwd, afull = phase_anchor_kernel(dev, cloud, cfg_a)
        abwd = phase_anchor_backward(dev, cfg_a, afull)
        del afull
        _, med_a = phase_render(dev, cloud, cfg_a, ref=frame)
    p_fwd, p_bwd = phase_project(dev, cloud, cfg)
    binning = phase_binning(dev)
    adam = phase_adam(dev)
    step_ms = phase_step(dev, cloud, cfg)
    step_a = phase_step(dev, cloud, cfg_a, label="13 anchor", kernels="CD")
    with torch.no_grad():
        phase_serve(dev, cloud, cfg)
        phase_serve(dev, cloud, cfg_a, n_events=2, label="13 anchor",
                    kernel="C")
    ref = unsharded_reference(cloud, W, H, cfg)
    with one_rank_group() as mesh:
        sharded = phase_sharded(dev, cloud, cfg, frame, mesh, ref)
        phase_gaussian_sharded(dev, cloud, cfg, frame, mesh, ref)
    del ref
    phase_config(dev, cloud, cfg, frame)
    phase_packed(dev, cloud, frame, {
        "dup": med, "anchor": med_a, "step": step_ms, "step_a": step_a,
        "A": fwd, "B": bwd, "C": afwd, "D": abwd, "E": tiles})
    phase_bench(dev, cloud)
    del cloud
    phase_cli_render()
    with tempfile.TemporaryDirectory() as capture_dir:
        trained, capture = phase_train(dev, cfg, capture_dir=capture_dir)
        trained_a, _ = phase_train(dev, cfg_a, iterations=10,
                                   label="14 anchor", kernels="CD")
        phase_train(dev, CFG_P, iterations=10, label="20 packed train")
        phase_cli_train(dev, cfg)
        phase_eval(capture)
    results = {"raster_fwd": fwd, "raster_bwd": bwd, "anchor_fwd": afwd,
               "anchor_bwd": abwd, **tiles, "project_fwd": p_fwd,
               "project_bwd": p_bwd, "bin": binning, "adam": adam}
    launches = {"raster_fwd": trained["A"], "raster_bwd": trained["B"],
                "anchor_fwd": trained_a["C"], "anchor_bwd": trained_a["D"],
                "raster_fwd_tiles": sharded["E-A"],
                "raster_bwd_tiles": sharded["E-B"],
                "project_fwd": trained["P"], "project_bwd": trained["P-bwd"],
                "bin": trained["bin"], "adam": trained["adam"]}
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
