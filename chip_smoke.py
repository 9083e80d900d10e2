#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's forward render path (project → bin → kernel A →
post-process) through the entry points a user calls, at the repo's
benchmark size: the 1M-splat SH-degree-3 `make_scene(1_000_000)` rendered
at 1920x1080 from the bench camera (eye (0, 0, -8) looking at the origin).
Phases, each printing one line; any failure raises and exits non-zero:

  0 device   nvidia-smi name and power limit; a CUDA device is required
  1 build    nvcc builds csrc/raster_fwd.cu at first use
  2 kernel   kernel A vs its plain PyTorch twin on the same bins: an
             opaque early-exit scene, a 72x40 ragged frame, and the full
             1080p frame (timed, CUDA events, median of 7 after warm-up)
  3 render   `render` for a few frames: one kernel launch per frame, a
             finite non-black image, pair and shrink counts against the
             JAX package's CPU figures; per-stage medians
  4 serve    `ViewerApp` at 1280x720 answers init/rotate/zoom/pan/tick
             with RGBA frames that encode to PNG
  5 cli      `python -m gaussian_splatting_web_tpu_torch.cli render
             --device cuda` on a 100k-splat PLY writes a PNG

Image rule (tests/conftest.py::assert_images_close): at most 2e-4 of the
pixels may differ by more than 2e-4; on the pixels that agree, the
residual log-transmittance agrees to 1e-4. TF32 is switched off for
matmuls and cuDNN so the plain twin computes in full f32.

Prints the card line, a JSON line of kernel results, and last
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from gaussian_splatting_web_tpu_torch.bench_lib import make_scene
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core.camera import default_camera
from gaussian_splatting_web_tpu_torch.io.ply import write_ply
from gaussian_splatting_web_tpu_torch.ops.composite import post_process
from gaussian_splatting_web_tpu_torch.ops.cuda import build
from gaussian_splatting_web_tpu_torch.ops.cuda import raster as raster_cuda
from gaussian_splatting_web_tpu_torch.ops.projection import project_gaussians
from gaussian_splatting_web_tpu_torch.ops.rasterize import (
    composite_image_plain,
    pack_splat_fields,
    rasterize_tiles,
    render,
)
from gaussian_splatting_web_tpu_torch.ops.sort import bin_splats
from gaussian_splatting_web_tpu_torch.utils.image import encode_png
from gaussian_splatting_web_tpu_torch.viewer.server import ViewerApp

REPO = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
N_SCENE = 1_000_000
# the JAX package's exact-mode projection + binning of this scene and
# camera on the CPU: live (tile, splat) pairs and centre-shrunk splats
CPU_PAIRS, CPU_OVERFLOW = 2_150_328, 13
ATOL, MAX_BAD_FRAC, LOG_T_TOL = 2e-4, 2e-4, 1e-4
KERNEL_SOURCE = "gaussian_splatting_web_tpu_torch/csrc/raster_fwd.cu"
KERNEL_REPLACES = "gaussian_splatting_web_tpu/ops/pallas/raster.py:219"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, runs, warmup=2):
    """Median device time of fn() in ms, CUDA events around each run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(got, want, what):
    """Hold kernel output against the plain twin by the image rule."""
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
    build.load("raster_fwd")
    dt = time.perf_counter() - t0
    log = build.build_logs.get("raster_fwd")
    ptxas = " ".join(ln.split("ptxas info    :")[-1].strip()
                     for ln in (log or "").splitlines()
                     if "registers" in ln)
    how = "built" if log is not None else "loaded (cached build)"
    print(f"[1 build] raster_fwd.cu {how} in {dt:.2f} s; ptxas: "
          f"{ptxas or 'n/a'}")


def phase_kernel(dev, cloud, cfg):
    findings = {}
    # small scenes first: opaque stack (early exit) and a ragged frame
    rng = np.random.default_rng(7)
    n = 40
    opaque = make_scene(n, seed=5, sh_degree=0, device=dev)
    opaque.xyz = torch.from_numpy(np.concatenate(
        [rng.normal(scale=0.05, size=(n, 2)), rng.uniform(-2, 2, (n, 1))],
        axis=1).astype(np.float32)).to(dev)
    opaque.opacity_logit = torch.full((n,), 6.0, device=dev)
    opaque.log_scale = torch.full((n, 3), -0.7, device=dev)
    small = make_scene(2000, seed=3, sh_degree=3, device=dev)
    cases = [("opaque 48x48", opaque, 48, 48, -6.0),
             ("ragged 72x40", small, 72, 40, -8.0)]
    for what, scene, w, h, z in cases:
        camera = default_camera(w, h, eye=(0, 0, z), center=(0, 0, 0)).to(dev)
        fields, bins = binned(scene, camera, w, h, cfg)
        got = raster_cuda.composite_image(fields, bins, w, h, cfg)
        want = composite_image_plain(fields, bins, w, h, cfg)
        findings[what] = compare(got, want, what)
        if what.startswith("opaque"):
            check(bool((got.alpha > 0.999).any()), "opaque scene: no pixel "
                  "saturated, the early exit was not exercised")

    camera = bench_camera(W, H, dev)
    fields, bins = binned(cloud, camera, W, H, cfg)
    got = raster_cuda.composite_image(fields, bins, W, H, cfg)
    want = composite_image_plain(fields, bins, W, H, cfg)
    full = compare(got, want, "1080p")
    ms = median_ms(
        lambda: raster_cuda.composite_image(fields, bins, W, H, cfg), 7)
    plain_ms = median_ms(
        lambda: composite_image_plain(fields, bins, W, H, cfg), 7, warmup=1)
    findings["1080p"] = full
    print(f"[2 kernel] kernel A vs plain twin: "
          + "; ".join(f"{k}: max_abs_err {v['max_abs_err']:.3e}, "
                      f">{ATOL} on {v['bad_frac']:.2e}, "
                      f"log-T err {v['log_t_err']:.2e}, "
                      f"last-idx diff {v['last_idx_frac']:.2e}"
                      for k, v in findings.items())
          + f"; 1080p kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"max_abs_err": full["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms}


def phase_render(dev, cloud, cfg, frames=5):
    camera = bench_camera(W, H, dev)
    stages = {"projection": [], "binning": [], "composite": [], "frame": []}
    for _ in range(3):           # stage split: host clock + synchronize
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        splats = project_gaussians(cloud, camera, W, H, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bins = bin_splats(splats, W, H, cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rasterize_tiles(splats, bins, W, H, cfg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        stages["projection"].append((t1 - t0) * 1e3)
        stages["binning"].append((t2 - t1) * 1e3)
        stages["composite"].append((t3 - t2) * 1e3)

    raster_cuda.launches = 0     # count only the main path's launches
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, aux = render(cloud, camera, W, H, cfg)
        rgba = post_process(img, aux["alpha"], cfg)
        torch.cuda.synchronize()
        stages["frame"].append((time.perf_counter() - t0) * 1e3)
    launches = raster_cuda.launches
    check(launches == frames,
          f"render launched kernel A {launches} times in {frames} frames")
    check(img.shape == (H, W, 3) and rgba.shape == (H, W, 4), "frame shape")
    check(bool(torch.isfinite(rgba).all()), "non-finite frame")
    mean = rgba[..., :3].mean().item()
    covered = (aux["alpha"] > 0.01).float().mean().item()
    check(mean > 1e-3 and covered > 0.05, f"black frame (mean {mean:.2e})")
    num_pairs = int(aux["num_pairs"])
    overflow = int(aux["overflow"])
    check(abs(num_pairs - CPU_PAIRS) <= 1e-3 * CPU_PAIRS,
          f"num_pairs {num_pairs} vs CPU {CPU_PAIRS}")
    check(abs(overflow - CPU_OVERFLOW) <= 5,
          f"overflow {overflow} vs CPU {CPU_OVERFLOW}")
    med = {k: statistics.median(v) for k, v in stages.items()}
    print(f"[3 render] {frames} frames {W}x{H}, launches={launches}, "
          f"num_pairs={num_pairs} (CPU {CPU_PAIRS}), overflow={overflow} "
          f"(CPU {CPU_OVERFLOW}), visible={int(aux['num_visible'])}, "
          f"mean rgb {mean:.4f}, alpha>0.01 on {covered:.3f}; medians ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in med.items()))
    return launches


def phase_serve(dev, cloud, cfg):
    app = ViewerApp(cloud, 1280, 720, cfg, device=dev)
    events = [{"kind": "init"}, {"kind": "rotate", "dx": 0.3, "dy": 0.1},
              {"kind": "zoom", "d": -300}, {"kind": "pan", "dx": 0.05,
                                            "dy": 0.02}, {"kind": "tick"}]
    before = raster_cuda.launches
    sizes, times = [], []
    for ev in events:
        t0 = time.perf_counter()
        frame, _ = app.handle_event(ev)
        png = encode_png(frame)
        times.append((time.perf_counter() - t0) * 1e3)
        check(frame.shape == (720, 1280, 4), f"{ev['kind']}: {frame.shape}")
        check(bool(np.isfinite(frame).all()) and frame[..., 3].max() > 0,
              f"{ev['kind']}: empty or non-finite frame")
        check(png[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
        sizes.append(len(png))
    rose = raster_cuda.launches - before
    check(rose == len(events), f"serve launched kernel A {rose} times")
    print(f"[4 serve] ViewerApp 1280x720 answered "
          + ", ".join(e["kind"] for e in events)
          + f"; launches +{rose}; PNG bytes {sizes}; ms per event "
          + ", ".join(f"{t:.1f}" for t in times))


def _decode_png(png: bytes) -> np.ndarray:
    """Decode the port's own filter-0 RGBA PNGs."""
    pos, idat = 8, b""
    w = h = 0
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        tag, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", data[:8])
            check(data[9] == 6, "PNG is not RGBA")
        elif tag == b"IDAT":
            idat += data
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    check(bool((rows[:, 0] == 0).all()), "unexpected PNG row filter")
    return rows[:, 1:].reshape(h, w, 4)


def phase_cli():
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "scene100k.ply")
        write_ply(make_scene(100_000, seed=1), ply)
        out = os.path.join(tmp, "renders")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gaussian_splatting_web_tpu_torch.cli",
             "render", "--ply", ply, "--out", out, "--device", "cuda",
             "--width", "1280", "--height", "720"],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t0
        check(proc.returncode == 0, f"cli render failed:\n{proc.stderr}")
        pngs = sorted(os.listdir(out))
        check(len(pngs) == 1, f"cli wrote {pngs}")
        with open(os.path.join(out, pngs[0]), "rb") as f:
            img = _decode_png(f.read())
        check(img.shape == (720, 1280, 4), f"PNG shape {img.shape}")
        check(int(img[..., 3].max()) > 0, "PNG is empty")
        last = [ln for ln in proc.stderr.splitlines() if "Mpix/s" in ln]
        check(len(last) == 1, f"cli output:\n{proc.stderr}")
        print(f"[5 cli] render --device cuda on a 100k-splat PLY → "
              f"{pngs[0]} {img.shape}, alpha>0 on "
              f"{float((img[..., 3] > 0).mean()):.3f}; process {dt:.1f} s; "
              f"cli says: {last[0].split('  ', 1)[-1]}")


def main():
    dev = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    cfg = RenderConfig()
    with torch.no_grad():
        t0 = time.perf_counter()
        cloud = make_scene(N_SCENE, seed=0, sh_degree=3, device=dev)
        print(f"[scene] make_scene({N_SCENE}) on {dev} in "
              f"{time.perf_counter() - t0:.1f} s")
        kernel = phase_kernel(dev, cloud, cfg)
        launches = phase_render(dev, cloud, cfg)
        phase_serve(dev, cloud, cfg)
    phase_cli()
    print(json.dumps({"kernels": [{
        "name": "raster_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
