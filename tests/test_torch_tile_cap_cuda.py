"""Kernels A and B and their tile-list entries E-A and E-B at a per-tile
pair cap above 1,024, on a tile that holds more than 1,024 pairs and
pixels that composite past their 1,024th pair, against the plain twins:
the helpers of `test_torch_cuda.py` with `max_per_tile` 4,096.

Marked `gpu`: every test skips without a CUDA device. The file imports
neither jax nor tests/conftest.py, so it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_tile_cap_cuda.py
"""

import numpy as np
import pytest
import torch

from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core.types import GaussianCloud

from test_torch_cuda import (  # noqa: F401  (the fixture)
    _backward_vs_plain,
    _kernel_vs_plain,
    _tiles_vs_full,
    device,
)

pytestmark = pytest.mark.gpu

CAP = RenderConfig(max_dup=16, max_per_tile=4096)
W, H = 64, 64


def crowded_cloud(n=3000, seed=5) -> GaussianCloud:
    """`test_torch_tile_cap.crowded_cloud`'s scene: faint splats about the
    frame's centre, so central pixels stay open past their 1,024th pair."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = torch.from_numpy
    return GaussianCloud(
        xyz=t(rng.normal(scale=0.15, size=(n, 3)).astype(np.float32)),
        log_scale=t(rng.uniform(-2.0, -1.6, size=(n, 3)).astype(np.float32)),
        quat=t(q),
        opacity_logit=torch.full((n,), float(np.log(0.006 / 0.994))),
        sh=t(rng.normal(scale=0.3, size=(n, 1, 3)).astype(np.float32)))


def test_kernels_past_1024_pairs_match_plain(device):
    out = _kernel_vs_plain(crowded_cloud(), W, H, device, CAP)
    assert int(out.last_idx.max()) > 1024
    _backward_vs_plain(crowded_cloud(), W, H, device, CAP)


def test_tile_list_kernels_past_1024_pairs(device):
    _tiles_vs_full(crowded_cloud(), W, H, device, CAP, n_shards=4, chunk=1)
