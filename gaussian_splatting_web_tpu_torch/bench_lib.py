"""Benchmark scene of the port. Only `make_scene` is ported so far (the
H100 bench itself is ROADMAP §1 item 7).

`make_scene` makes the same NumPy draws in the same order as the JAX
package's `bench_lib.make_scene`, so one seed gives both packages
identical arrays.
"""

from __future__ import annotations

import types

import numpy as np

from .core.types import GaussianCloud


def make_scene(n, seed=0, sh_degree=3, log_scale_range=(-6.0, -4.0),
               device="cpu") -> GaussianCloud:
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
