"""Benchmark scene and gradient-parity rule of the port (the H100 bench
itself is ROADMAP §1 item 7).

`make_scene` makes the same NumPy draws in the same order as the JAX
package's `bench_lib.make_scene`, so one seed gives both packages
identical arrays. `grad_parity` is the scale-relative rule of the JAX
package's `bench_lib._grad_parity`; `image_rule` is the repo's image rule
(`tests/conftest.py::assert_images_close`). `unsharded_reference` and
`step_parity` hold a sharded training step to the unsharded one
(`chip_smoke.py` on one card, `multichip_check.py` across the cards).
"""

from __future__ import annotations

import math
import types

import numpy as np
import torch

from .core.camera import default_camera
from .core.types import GaussianCloud

# the parity gate: p99 of the scale-relative error, and the share of
# elements off by more than 1% of their leaf's scale
GRAD_P99, GRAD_BIG, GRAD_BIG_FRAC = 1e-3, 1e-2, 1e-5
GRAD_EXTRA = 2            # knife-edge outliers allowed on top of 1e-5 of n
# the image rule: at most IMAGE_BAD_FRAC of the pixels off by more than
# IMAGE_ATOL in some channel
IMAGE_ATOL, IMAGE_BAD_FRAC = 2e-4, 2e-4


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
