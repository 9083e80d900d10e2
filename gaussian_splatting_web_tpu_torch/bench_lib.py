"""The port's bench (the JAX package's `bench_lib.py`), its benchmark
scenes, its work count and its gradient-parity rule.

`run` measures the port's main path on one device with the port's shipped
`RenderConfig()` (or the config it is given): forward render throughput
(Mpix/s) at the target resolution, forward+backward throughput, bin+sort
throughput (M splats/s), a roofline table against one H100's peaks, and,
on a CUDA device, a gradient-parity gate of kernels A and B against their
plain twins on the same bins. Details go to stderr; one JSON line goes to
stdout. `cli bench` calls it.

`make_scene` makes the same NumPy draws in the same order as the JAX
package's `bench_lib.make_scene`, so one seed gives both packages
identical arrays. `grad_parity` is the scale-relative rule of the JAX
package's `bench_lib._grad_parity`; `image_rule` is the repo's image rule
(`tests/conftest.py::assert_images_close`). `unsharded_reference` and
`step_parity` hold a sharded training step to the unsharded one
(`chip_smoke.py` on one card, `multichip_check.py` across the cards).
`work` and `bound` count what kernels A-E need on this run's data and the
least time an H100 could take for it; `chip_smoke.py` and `run` share
them.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import types

import numpy as np
import torch
import torch.nn.functional as F

from .config import RenderConfig
from .core.camera import default_camera
from .core.types import GaussianCloud
from .ops import rasterize
from .ops.projection import project_gaussians
from .ops.sort import bin_splats
from .utils.metrics import throughput_mpixps, time_fn

BASELINE_MPIXPS = 60.0  # 30 fps at 1080p, the interactive north star

# the parity gate: p99 of the scale-relative error, and the share of
# elements off by more than 1% of their leaf's scale
GRAD_P99, GRAD_BIG, GRAD_BIG_FRAC = 1e-3, 1e-2, 1e-5
GRAD_EXTRA = 2            # knife-edge outliers allowed on top of 1e-5 of n
# the image rule: at most IMAGE_BAD_FRAC of the pixels off by more than
# IMAGE_ATOL in some channel
IMAGE_ATOL, IMAGE_BAD_FRAC = 2e-4, 2e-4

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
             "anchor_bwd": 35, "raster_fwd_tiles": 12,
             "raster_bwd_tiles": 35}
PASS_SFU = {"raster_fwd": 3, "raster_bwd": 4, "anchor_fwd": 3,
            "anchor_bwd": 4, "raster_fwd_tiles": 3, "raster_bwd_tiles": 4}
# one footprint test (csrc/footprint.cuh): 27 mul, 22 add, 36 compares and
# 6 abs in FP32; two divisions and two square roots on the SFUs
FOOT_FP32, FOOT_SFU = 91, 4


def make_scene(n, seed=0, sh_degree=3, log_scale_range=(-6.0, -4.0),
               device="cuda") -> GaussianCloud:
    """Synthetic scene shaped like an INRIA-trained capture: many small
    splats, screen footprints of a few pixels to a couple of tiles."""
    rng = np.random.default_rng(seed)
    k = {0: 1, 1: 4, 2: 9, 3: 16}[sh_degree]
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    arrays = types.SimpleNamespace(
        xyz=(rng.normal(size=(n, 3)) * 2.0).astype(np.float32),
        log_scale=rng.uniform(*log_scale_range, size=(n, 3)).astype(np.float32),
        quat=q,
        opacity_logit=rng.uniform(-3, 1, size=(n,)).astype(np.float32),
        sh=rng.normal(scale=0.3, size=(n, k, 3)).astype(np.float32),
    )
    return GaussianCloud.from_numpy(arrays, device=device)


def make_adversarial_scene(seed=11, device="cuda") -> GaussianCloud:
    """Splats at the edges of the compositor kernels' footprint cull, for
    a 96x64 frame seen from eye (0, 0, -6): very anisotropic needles,
    centres outside the frame whose footprints reach into it, opacities
    just above the 1/255 cutoff (logit(1/255) = -ln 254 ≈ -5.537, some
    exactly there), sub-pixel splats, and splats wide enough to cover
    more than `max_dup` = 16 of the frame's 24 tiles."""
    rng = np.random.default_rng(seed)
    groups = []

    def group(n, xy, z, log_scale, logit):
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        groups.append((np.concatenate([xy, z], 1), log_scale, q, logit))

    needle = rng.uniform(-5.0, -4.0, size=(60, 3))
    needle[np.arange(60), rng.integers(0, 3, 60)] = rng.uniform(0.0, 0.5, 60)
    group(60, rng.normal(scale=1.5, size=(60, 2)), rng.uniform(-1, 1, (60, 1)),
          needle, rng.uniform(-3, 2, 60))
    side = rng.choice([-1.0, 1.0], size=(40, 2))
    group(40, side * rng.uniform([6.0, 4.0], [9.0, 6.0], (40, 2)),
          rng.uniform(-1, 1, (40, 1)), rng.uniform(0.0, 0.7, (40, 3)),
          rng.uniform(-1, 3, 40))
    logit = rng.uniform(-np.log(254.0), -5.4, 40)
    logit[:8] = -np.log(254.0)
    group(40, rng.normal(scale=1.5, size=(40, 2)), rng.uniform(-1, 1, (40, 1)),
          rng.uniform(-3.0, -1.5, (40, 3)), logit)
    group(40, rng.normal(scale=1.5, size=(40, 2)), rng.uniform(-1, 1, (40, 1)),
          rng.uniform(-7.0, -6.0, (40, 3)), rng.uniform(1, 4, 40))
    group(10, rng.normal(scale=1.0, size=(10, 2)), rng.uniform(-1, 1, (10, 1)),
          rng.uniform(1.0, 1.5, (10, 3)), rng.uniform(-4, -2, 10))
    xyz, log_scale, quat, logit = (np.concatenate(a).astype(np.float32)
                                   for a in zip(*groups))
    arrays = types.SimpleNamespace(
        xyz=xyz, log_scale=log_scale, quat=quat, opacity_logit=logit,
        sh=rng.normal(scale=0.3, size=(xyz.shape[0], 1, 3)).astype(np.float32))
    return GaussianCloud.from_numpy(arrays, device=device)


def grad_parity(got, want) -> dict:
    """Scale-relative error of gradient leaves (pairs of arrays or
    tensors): err = |got − want| / max|want| per leaf, pooled over all
    elements → p50, p99, max, the count over 1% (`nbig`) and the element
    count `n`. The tail it tolerates is discrete: a pair within an ulp of
    the 1/255 cutoff, the 0.99 clamp or the 1e-4 early exit flips its whole
    local contribution in one path and not the other, so outliers are
    bounded in count, not magnitude."""
    def flat(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, dtype=np.float64).reshape(-1)

    rels = []
    for a, b in zip(got, want):
        a, b = flat(a), flat(b)
        if b.size:
            rels.append(np.abs(a - b) / (np.abs(b).max() + 1e-12))
    rel = np.concatenate(rels)
    return {
        "p50": float(np.percentile(rel, 50)),
        "p99": float(np.percentile(rel, 99)),
        "max": float(rel.max()),
        "nbig": int((rel > GRAD_BIG).sum()),
        "n": int(rel.size),
    }


def grad_parity_ok(stats: dict, extra: int = 0) -> bool:
    """The gate: p99 ≤ 1e-3 and at most 1e-5 of the elements (plus `extra`
    knife-edge outliers) off by more than 1%."""
    return (stats["p99"] <= GRAD_P99
            and stats["nbig"] <= GRAD_BIG_FRAC * stats["n"] + extra)


def image_rule(img: torch.Tensor, ref: torch.Tensor) -> dict:
    """[..., H, W, C] images → the largest channel error, the share of
    pixels over IMAGE_ATOL (`bad_frac`), whether they are equal bit for
    bit, and whether the rule holds (`ok`)."""
    diff = (img - ref).abs().amax(-1)
    bad = float((diff > IMAGE_ATOL).float().mean())
    return {"max_abs_err": float(diff.max()), "bad_frac": bad,
            "bitwise": bool(torch.equal(img, ref)),
            "ok": bad <= IMAGE_BAD_FRAC}


def orbit_camera(i, n, w, h, radius=8.0):
    """View i of n around the origin at `radius`, 0.5 above it."""
    a = 2 * math.pi * i / n
    return default_camera(w, h, eye=(radius * math.sin(a), 0.5,
                                     -radius * math.cos(a)),
                          center=(0, 0, 0))


def unsharded_reference(cloud: GaussianCloud, w: int, h: int, config,
                        views: int = 2):
    """The views 0..views-1 of 8 around the scene, their targets (0.8 ×
    `render`), and the unsharded mean photometric loss over them with the
    parameter gradients of a model made from `cloud` → (cameras, targets,
    loss, {parameter: gradient}); the sharded steps are held to it."""
    from .models.gaussian_model import PARAMS, GaussianModel
    from .ops.rasterize import render
    from .train.loss import photometric_loss

    cams = [orbit_camera(i, 8, w, h).to(cloud.xyz.device)
            for i in range(views)]
    with torch.no_grad():
        targets = torch.stack([0.8 * render(cloud, c, w, h, config)[0]
                               for c in cams])
    ref = GaussianModel.from_cloud(cloud)
    loss = sum(photometric_loss(render(ref.to_cloud(), c, w, h, config)[0],
                                tgt) for c, tgt in zip(cams, targets)) / views
    loss.backward()
    grads = {f: getattr(ref, f).grad for f in PARAMS
             if getattr(ref, f).numel()}
    return cams, targets, float(loss.detach()), grads


def step_parity(loss: float, grads, reference) -> dict:
    """A sharded step's loss and gradients (in the reference's parameter
    order, shards put back together) against `unsharded_reference`'s →
    the loss's relative error `rel`, `grad_parity`'s `stats`, `bitwise`,
    and `ok`: rel ≤ 1e-5 and the gradient rule with GRAD_EXTRA."""
    ref_loss, want = reference[2], list(reference[3].values())
    rel = abs(loss - ref_loss) / abs(ref_loss)
    stats = grad_parity(grads, want)
    return {"rel": rel, "stats": stats,
            "bitwise": all(torch.equal(a, b) for a, b in zip(grads, want)),
            "ok": rel <= 1e-5 and grad_parity_ok(stats, GRAD_EXTRA)}


# --- work and bound of the compositor kernels -------------------------------


def work(fields, bins, comp, w, h, cfg, tile_ids=None):
    """Pair-pixel steps of this frame (of the real tiles of `tile_ids`,
    default all), for A and B: `steps` walked, of which `passed` pass the
    cutoff, and the (pair, tile)s some pixel of the tile walks to, `pairs`.
    A walks each pixel up to and including its early-exit pair (the whole
    segment if it never saturates); B walks each pixel up to its last
    contributing pair."""
    gx, gy = cfg.grid_size(w, h)
    ts = cfg.tile_size
    dev = fields.device
    if tile_ids is None:
        tile_ids = torch.arange(gx * gy, device=dev)
    tile_ids = tile_ids[tile_ids < gx * gy].long()
    inside = rasterize.tile_major(torch.ones((h, w, 1), device=dev), gx, gy,
                                  ts)[tile_ids, :, 0] > 0         # [T, P]
    last = rasterize.tile_major(comp.last_idx[..., None], gx, gy, ts,
                                fill=-1)[tile_ids, :, 0]
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


def work_ops(name, w):
    """(FP32 operations, SFU operations) kernel `name` needs for the work
    `w` (one kernel's entry of `work`): the passing steps at full cost and
    one footprint test per pair."""
    return (w["passed"] * (STEP_FP32 + PASS_FP32[name])
            + w["pairs"] * FOOT_FP32,
            w["passed"] * PASS_SFU[name] + w["pairs"] * FOOT_SFU)


def bound(name, w, nbytes):
    """(bound_ms, bound_by, step_bound_ms) for the work `w` (one kernel's
    entry of `work`) and `nbytes`: the bound counts `work_ops`; the step
    bound counts a power evaluation at every walked step."""
    flops, sfu = work_ops(name, w)
    ops_s = max(flops / FP32_FLOPS_S, sfu / SFU_OPS_S)
    bytes_s = nbytes / HBM_BYTES_S
    step_flops = w["steps"] * STEP_FP32 + w["passed"] * PASS_FP32[name]
    step_s = max(step_flops / FP32_FLOPS_S,
                 w["passed"] * PASS_SFU[name] / SFU_OPS_S, bytes_s)
    return (max(ops_s, bytes_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations", step_s * 1e3)


def raster_bytes(fields, bins, w, h, cfg, dpairs=None):
    """Bytes kernel A moves over a full frame, each input read once and
    each output written once: the [N, 12] fields, the pairs' gaussian ids,
    the tiles' starts and counts, and the frame's rgb, alpha, log-T and
    last index. With `dpairs`, kernel B's: the same inputs (the frame's
    outputs now read back as the residual and the cotangent) and its pair
    rows."""
    t = cfg.num_tiles(w, h)
    nbytes = (fields.numel() * 4 + bins.sorted_gidx.numel() * 4 + t * 8
              + h * w * 6 * 4)
    return nbytes if dpairs is None else nbytes + dpairs.numel() * 4


# --- the bench ---------------------------------------------------------------


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _roofline(stage, measured_s, bytes_, fp32=0, sfu=0):
    """One roofline row against one H100's peaks: the least time for
    `bytes_` of HBM traffic, `fp32` FP32 operations and `sfu`
    special-function operations (the largest of the three), beside the
    measured time."""
    t_bw = bytes_ / HBM_BYTES_S
    t_fp = fp32 / FP32_FLOPS_S
    t_sfu = sfu / SFU_OPS_S
    least = max(t_bw, t_fp, t_sfu, 1e-12)
    pct = 100.0 * least / max(measured_s, 1e-12)
    by = "bytes" if t_bw >= max(t_fp, t_sfu) else "operations"
    _log(f"  {stage:<16s} {measured_s * 1e3:9.3f} ms   bound "
         f"{least * 1e3:8.4f} ms (bytes {t_bw * 1e3:.4f} / fp32 "
         f"{t_fp * 1e3:.4f} / sfu {t_sfu * 1e3:.4f}) by {by}   "
         f"{pct:6.2f}% of roofline")
    return {"ms": measured_s * 1e3, "bound_ms": least * 1e3,
            "bound_by": by, "pct_roofline": pct}


LEAVES = ("mean2d", "conic", "rgb", "opacity")   # what reaches the compositor


def _leaves(splats):
    """Fresh leaves of the splats' compositor fields → (splats with them,
    leaves)."""
    leaves = [getattr(splats, f).detach().requires_grad_(True)
              for f in LEAVES]
    return dataclasses.replace(splats, **dict(zip(LEAVES, leaves))), leaves


def _kernel_grads(splats, bins, width, height, config, weight):
    """The gate's kernel path: kernels A and B through `CompositeFn`
    (`rasterize_tiles`) → (loss, gradients of LEAVES)."""
    s, leaves = _leaves(splats)
    out = rasterize.rasterize_tiles(s, bins, width, height, config)
    loss = (out.rgb * weight).sum() + out.alpha.sum()
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


def _twin_grads(splats, bins, width, height, config, weight):
    """The gate's plain path: `composite_image_plain`,
    `composite_backward_plain` and `fold_pair_grads` on the same tensors
    (the backward `CompositeFn` runs, with the twins in the kernels'
    place) → (loss, gradients of LEAVES)."""
    s, leaves = _leaves(splats)
    fields = rasterize.highlight_selected(
        rasterize.pack_splat_fields(s, config), config)
    with torch.no_grad():
        out = rasterize.composite_image_plain(fields, bins, width, height,
                                              config)
        d_rgb = weight.expand(height, width, 3).contiguous()
        d_alpha = torch.ones((height, width), device=fields.device)
        dpairs = rasterize.composite_backward_plain(
            fields, bins, width, height, config, out, d_rgb, d_alpha)
        g = F.pad(rasterize.fold_pair_grads(dpairs, bins, fields.shape[0],
                                            config),
                  (0, rasterize.FIELD_ROW - rasterize.GRAD_ROW))
        loss = (out.rgb * weight).sum() + out.alpha.sum()
    return float(loss), torch.autograd.grad(fields, leaves, g)


def _grad_parity(cloud, camera, width, height, config):
    """Kernel vs plain-twin gradients on the same device and bins, with the
    JAX package's weighted loss sum(rgb · linspace(0.5, 1.5, W)) +
    sum(alpha): `grad_parity` pooled over LEAVES (each leaf scaled by its
    own max), the forward losses' relative difference `loss_rel`, and the
    gate `ok` (p99 ≤ 1e-3, at most 1e-5 of the elements over 1%)."""
    with torch.no_grad():
        splats = project_gaussians(cloud, camera, width, height, config)
        bins = bin_splats(splats, width, height, config)
    weight = torch.linspace(0.5, 1.5, width,
                            device=splats.depth.device)[None, :, None]
    loss_k, got = _kernel_grads(splats, bins, width, height, config, weight)
    loss_t, want = _twin_grads(splats, bins, width, height, config, weight)
    stats = grad_parity(got, want)
    stats["loss_rel"] = abs(loss_k - loss_t) / (abs(loss_t) + 1e-12)
    stats["ok"] = grad_parity_ok(stats)
    return stats


def _gate(cloud, camera, width, height, config):
    """`_grad_parity` where the kernels run (a CUDA cloud); None on the
    CPU, where both of its paths would be the plain twin."""
    if cloud.xyz.device.type != "cuda":
        return None
    return _grad_parity(cloud, camera, width, height, config)


def run(ply=None, width=1920, height=1080, n_synthetic=1_000_000,
        emit_json=True, check_grads=True, device="cuda",
        config=None) -> dict:
    """Bench the port's main path on `device` (a CUDA device that is not
    there raises) with `config` (default: the port's `RenderConfig()`), on
    `ply` or on `make_scene(n_synthetic)`, at width × height → the result
    dict; with `emit_json`, one JSON line on stdout: the JAX package's four
    keys and `parity_gate_ok` (None where the gate did not run)."""
    from .io.ply import read_ply
    from .ops.rasterize import render_impl

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available")
    config = RenderConfig() if config is None else config
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    _log(f"device={dev} ({name}) config={config}")
    if ply:
        cloud = read_ply(ply, device=dev)
        lo, hi = cloud.bbox()
        center = ((lo + hi) / 2).cpu().numpy()
        eye = center + np.array([0, 0, -5.0])
    else:
        cloud = make_scene(n_synthetic, device=dev)
        center, eye = np.zeros(3), np.array([0, 0, -8.0])
    n = cloud.num_gaussians
    camera = default_camera(width, height, eye=eye, center=center).to(dev)
    pix = width * height

    def forward():
        with torch.no_grad():
            render_impl(cloud, camera, width, height, config)

    leaves = {f: getattr(cloud, f).detach().clone().requires_grad_(True)
              for f in ("xyz", "log_scale", "quat", "opacity_logit", "sh")}

    def fwd_bwd():
        for t in leaves.values():
            t.grad = None
        img, _ = render_impl(GaussianCloud(**leaves), camera, width, height,
                             config)
        img.sum().backward()

    t_f = time_fn(forward, iters=8, device=dev)
    t_b = time_fn(fwd_bwd, iters=6, device=dev)
    mpixps = throughput_mpixps(width, height, t_f["median"])
    _log(f"forward: {t_f['median'] * 1e3:.3f} ms (p90 "
         f"{t_f['p90'] * 1e3:.3f}) → {mpixps:.2f} Mpix/s ({n} gaussians at "
         f"{width}x{height})")
    _log(f"forward+backward: {t_b['median'] * 1e3:.3f} ms (p90 "
         f"{t_b['p90'] * 1e3:.3f}) → "
         f"{throughput_mpixps(width, height, t_b['median']):.2f} Mpix/s")

    with torch.no_grad():
        splats = project_gaussians(cloud, camera, width, height, config)
        t_s = time_fn(bin_splats, splats, width, height, config, iters=6,
                      device=dev)
        bins = bin_splats(splats, width, height, config)
    live, slots = int(bins.num_pairs), int(bins.sorted_slot.shape[0])
    tiles = int(bins.tile_count.shape[0])
    _log(f"bin+sort: {t_s['median'] * 1e3:.3f} ms (p90 "
         f"{t_s['p90'] * 1e3:.3f}) → {n / t_s['median'] / 1e6:.2f} M "
         f"splats/s; pairs: live={live} slots={slots} tiles={tiles} "
         f"overflow={int(bins.overflow)}")

    result = {
        "metric": f"forward_render_{height}p",
        "value": round(mpixps, 2),
        "unit": "Mpix/s",
        "vs_baseline": round(mpixps / BASELINE_MPIXPS, 3),
        "fwd_bwd_mpixps": round(throughput_mpixps(width, height,
                                                  t_b["median"]), 2),
        "sort_msplats_per_s": round(n / t_s["median"] / 1e6, 2),
        "forward_ms": t_f["median"] * 1e3, "forward_p90_ms": t_f["p90"] * 1e3,
        "fwd_bwd_ms": t_b["median"] * 1e3, "fwd_bwd_p90_ms": t_b["p90"] * 1e3,
        "sort_ms": t_s["median"] * 1e3, "sort_p90_ms": t_s["p90"] * 1e3,
        "live_pairs": live, "slots": slots, "tiles": tiles,
        "overflow": int(bins.overflow), "num_gaussians": n,
        "width": width, "height": height, "device": name,
        "pct_roofline_forward": None, "pct_roofline_fwd_bwd": None,
    }
    if dev.type == "cuda":
        result["roofline"] = _roofline_rows(cloud, splats, bins, width,
                                            height, config, t_f, t_b, t_s)
        result["pct_roofline_forward"] = (
            result["roofline"]["forward total"]["pct_roofline"])
        result["pct_roofline_fwd_bwd"] = (
            result["roofline"]["fwd+bwd total"]["pct_roofline"])
    else:
        _log("roofline: not measured (the peaks are an H100's; this run is "
             "on the CPU)")
    del splats, bins

    result["parity_gate_ok"] = None
    g = _gate(cloud, camera, width, height, config) if check_grads else None
    if g is not None:
        _log(f"grad parity (kernels A and B vs their plain twins, same "
             f"device and bins): p50={g['p50']:.2e} p99={g['p99']:.2e} "
             f"max={g['max']:.2e} n>1%={g['nbig']}/{g['n']} "
             f"loss_rel={g['loss_rel']:.2e} gate(p99<=1e-3, "
             f"frac>1%<=1e-5): {'PASS' if g['ok'] else 'FAIL'}")
        result.update({f"parity_{k}": v for k, v in g.items() if k != "ok"})
        result["parity_gate_ok"] = bool(g["ok"])
    if emit_json:
        print(json.dumps({k: result[k] for k in
                          ("metric", "value", "unit", "vs_baseline",
                           "parity_gate_ok")}), flush=True)
    return result


def _roofline_rows(cloud, splats, bins, width, height, config, t_f, t_b,
                   t_s) -> dict:
    """The roofline table of a CUDA run: bin+sort, kernels A and B alone
    (CUDA events around one launch, after `prepare_fwd` / `prepare_bwd`
    did the checks and allocations), and the forward and fwd+bwd totals.
    A first count: each stage's inputs read once and outputs written once,
    so every share is at most 100%."""
    from .ops.cuda import raster as raster_cuda

    dev = splats.depth.device
    n, m = cloud.num_gaussians, int(bins.sorted_gidx.shape[0])
    t = config.num_tiles(width, height)
    cloud_row = 4 * (11 + 3 * cloud.sh.shape[1])   # xyz, scale, quat, op, sh
    fields = rasterize.pack_splat_fields(splats, config)
    run_a, (comp, _) = raster_cuda.prepare_fwd(fields, bins, width, height,
                                               config)
    t_a = time_fn(run_a, iters=7, device=dev)
    d_rgb = torch.ones((height, width, 3), device=dev)
    d_alpha = torch.ones((height, width), device=dev)
    run_b, (dpairs, _) = raster_cuda.prepare_bwd(fields, bins, width, height,
                                                 config, comp, d_rgb, d_alpha)
    t_kb = time_fn(run_b, iters=7, device=dev)
    steps = work(fields, bins, comp, width, height, config)
    ops_a = work_ops("raster_fwd", steps["A"])
    ops_b = work_ops("raster_bwd", steps["B"])
    bytes_a = raster_bytes(fields, bins, width, height, config)
    bytes_b = raster_bytes(fields, bins, width, height, config, dpairs)
    # bin+sort, counting only what the M live pairs need (the S padded
    # slots and the [S] permutation over them are the implementation's,
    # not the work's): the footprints read mean2d, conic, depth, opacity
    # and valid (29 bytes a splat); the key build writes each live pair's
    # int64 key and the sort reads it; the sort writes the sorted keys and
    # their int64 order (the live pairs' permutation); the binning writes
    # each pair's int32 gaussian id and the tiles' int32 starts and counts
    sort_bytes = n * 29 + m * (8 + 8) + m * (8 + 8) + m * 4 + t * 8
    # projection: reads the cloud, writes the projected splats (mean2d 8,
    # conic 12, depth 4, radius 4, rgb 12, opacity 4, valid 1 bytes) and
    # the packed [N, 12] f32 fields
    proj_bytes = n * (cloud_row + 45 + 48)
    # the fold reads B's [M, 9] f32 pair rows and each pair's int32
    # gaussian id and writes the [N, 9] sums (its [S, 9] slot buffer is
    # the implementation's, not the work's); the projection's backward
    # reads the [N, 12] field gradient and the cloud and writes the
    # cloud's gradient
    fold_bytes = m * (36 + 4) + n * 36
    proj_bwd_bytes = n * (48 + 2 * cloud_row)
    _log(f"roofline (H100 SXM peaks: {HBM_BYTES_S / 1e12:.2f} TB/s HBM, "
         f"{FP32_FLOPS_S / 1e12:.0f} TFLOP/s FP32, "
         f"{SFU_OPS_S / 1e12:.2f} T SFU ops/s):")
    return {
        "bin+sort": _roofline("bin+sort", t_s["median"], sort_bytes),
        "kernel A": _roofline("kernel A", t_a["median"], bytes_a, *ops_a),
        "kernel B": _roofline("kernel B", t_kb["median"], bytes_b, *ops_b),
        "forward total": _roofline(
            "forward total", t_f["median"],
            proj_bytes + sort_bytes + bytes_a, *ops_a),
        "fwd+bwd total": _roofline(
            "fwd+bwd total", t_b["median"],
            proj_bytes + sort_bytes + bytes_a + bytes_b + fold_bytes
            + proj_bwd_bytes, ops_a[0] + ops_b[0], ops_a[1] + ops_b[1]),
    }
