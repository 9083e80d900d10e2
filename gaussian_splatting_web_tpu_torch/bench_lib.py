"""Benchmark scene and gradient-parity rule of the port (the H100 bench
itself is ROADMAP §1 item 7).

`make_scene` makes the same NumPy draws in the same order as the JAX
package's `bench_lib.make_scene`, so one seed gives both packages
identical arrays. `grad_parity` is the scale-relative rule of the JAX
package's `bench_lib._grad_parity`.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from .core.types import GaussianCloud

# the parity gate: p99 of the scale-relative error, and the share of
# elements off by more than 1% of their leaf's scale
GRAD_P99, GRAD_BIG, GRAD_BIG_FRAC = 1e-3, 1e-2, 1e-5


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
