"""The "view" loop: a closed loop with one client. Each request renders
the next view of the traffic's `views` ("test" or "train") in turn through
the program's `ops/rasterize.py::render`, as `cli render` and the viewer
call it, under `torch.no_grad()`, and copies the frame to the host; it is
timed on the host clock from the call to the host copy. A frame that
raises ends the run.

Traffic parameters: `views`, `checked_frames` (views drawn from the seed
whose first frame of the window is compared with the reference's), and
`limits` for `frame_max_abs` and `frame_mean_abs` (`check.view_numbers`).
"""

from __future__ import annotations

import random
import time
import warnings
from typing import Dict, List

import torch

from benchmark import check, harness, inputs as inp, trace as tr
from benchmark.reference import full_f32, render as ref_render


def sample(ids: List[int], k: int, seed: int) -> List[int]:
    """The `k` views whose first frames of the window are checked."""
    return random.Random(seed ^ 0xC0FFEE).sample(ids, min(k, len(ids)))


def spans(rasterize) -> tr.Spans:
    return tr.Spans([(rasterize, "project_gaussians", "projection"),
                     (rasterize, "bin_splats", "binning"),
                     (rasterize, "rasterize_tiles", "composite")])


def counted_syncs(fn, arg, device):
    """fn(arg) with the synchronising CUDA calls it makes counted
    (`torch.cuda.set_sync_debug_mode`) → (result, count)."""
    if not harness.is_cuda(device):
        return fn(arg), 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            out = fn(arg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(c.message) for c in caught)


def reference_frames(cfg: dict, data: inp.Inputs, views, tf32=False):
    """The reference's frames of `views` (on the host) and its Counts."""
    full_f32()
    frames, counts = [], []
    for i in views:
        img, c = ref_render.render(data.scene, data.cameras[i], cfg["width"],
                                   cfg["height"], cfg["render"], tf32)
        frames.append(img.cpu())
        counts.append(c)
    return frames, counts


def program_cloud(scene: dict):
    from gaussian_splatting_web_tpu_torch.core.types import GaussianCloud

    return GaussianCloud(xyz=scene["xyz"], log_scale=scene["log_scale"],
                         quat=scene["quat"],
                         opacity_logit=scene["opacity_logit"],
                         sh=torch.cat([scene["sh_dc"], scene["sh_rest"]], 1))


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool, device,
        setup_clock) -> dict:
    from gaussian_splatting_web_tpu_torch.ops import rasterize

    cfg, traffic = cell.config, cell.traffic
    w, h = cfg["width"], cfg["height"]
    harness.mark("imports", setup_clock)
    data = inp.make_inputs(cfg, seed, device)
    ids = data.test_ids if traffic["views"] == "test" else data.train_ids
    checked = sample(ids, traffic["checked_frames"], seed)
    rcfg = harness.program_render_config(cfg)
    cloud = program_cloud(data.scene)
    cams = {i: harness.program_camera(data.cameras[i]) for i in ids}
    # one host buffer takes every frame, so no frame's time depends on
    # the host allocator's state; the checked frames are copied aside
    host = torch.empty((h, w, 3), dtype=torch.float32)
    aside = {i: torch.empty_like(host) for i in checked}

    def frame(i):
        with torch.no_grad():
            img, _ = rasterize.render(cloud, cams[i], w, h, rcfg)
        return host.copy_(img)

    harness.sync(device)
    harness.mark("inputs", setup_clock)
    for i in ids:                      # every shape of the traffic, once
        frame(i)
    for buf in aside.values():
        buf.fill_(0.0)
    harness.sync(device)
    setup_s = setup_clock()
    harness.mark("warm-up", setup_clock)

    kept: Dict[int, torch.Tensor] = {}
    lat: List[float] = []
    syncs = 0
    wrapped = spans(rasterize) if traced else None
    prof = harness.profiler(device) if traced else None
    with harness.maybe(prof, "trace stop"), harness.maybe(wrapped), \
            harness.window_range(traced):
        t0 = time.perf_counter()
        n = 0
        while True:
            i = ids[n % len(ids)]
            a = time.perf_counter()
            if traced:
                img, k = counted_syncs(frame, i, device)
                syncs += k
            else:
                img = frame(i)
            b = time.perf_counter()
            lat.append(b - a)
            if i in aside and i not in kept:
                kept[i] = aside[i].copy_(img)
            n += 1
            if b - t0 >= seconds and len(kept) == len(checked):
                break
        window_s = time.perf_counter() - t0
    peak = harness.memory_peak(device)
    del cloud, cams
    harness.release(device)

    ref, counts = reference_frames(cfg, data, checked)
    numbers = check.view_numbers([kept[i] for i in checked], ref)
    metrics = {"render_fps": n / window_s,
               "frame_p95_ms": harness.p95(lat) * 1e3, "setup_s": setup_s}
    ctx = harness.Context(
        loop="view", config=cfg, requests=n, window_s=window_s,
        summary=harness.reduce_trace(prof) if traced else None,
        counts=counts, syncs_per_request=syncs / n if traced else None)
    return harness.result(cell, numbers, metrics, ctx, n, 0, peak, device,
                          traced)


def readings(cell: harness.Cell, seed: int, device) -> dict:
    """The check's numbers for one seed (`tools/control.py`): "program",
    the program's frames of the checked views; "control", the reference
    computed in TF32 put in the program's place."""
    from gaussian_splatting_web_tpu_torch.ops import rasterize

    cfg = cell.config
    data = inp.make_inputs(cfg, seed, device)
    ids = (data.test_ids if cell.traffic["views"] == "test"
           else data.train_ids)
    checked = sample(ids, cell.traffic["checked_frames"], seed)
    cloud = program_cloud(data.scene)
    rcfg = harness.program_render_config(cfg)
    prog = []
    with torch.no_grad():
        for i in checked:
            img, _ = rasterize.render(cloud, harness.program_camera(
                data.cameras[i]), cfg["width"], cfg["height"], rcfg)
            prog.append(img.cpu())
    del cloud
    harness.release(device)
    ref, _ = reference_frames(cfg, data, checked)
    low, _ = reference_frames(cfg, data, checked, tf32=True)
    return {"program": check.view_numbers(prog, ref),
            "control": check.view_numbers(low, ref)}
