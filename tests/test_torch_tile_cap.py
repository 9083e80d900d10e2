"""A per-tile pair cap above 1,024 (`RenderConfig.max_per_tile`, raised for
Rubble's 40.4M Gaussians, whose crowded tiles hold about 100,000 pairs):
on a tile that holds more than 1,024 pairs, the port's binning equals the
JAX package's at the raised cap, and its frame through the plain twin of
kernel A equals the JAX package's; at the shipped cap of 1,024 the same
frame differs, so the raised cap is what the frame needs. The kernels'
side of it runs on the card (`test_torch_tile_cap_cuda.py`)."""

import dataclasses

import numpy as np
import torch

from gaussian_splatting_web_tpu.config import RenderConfig as JaxConfig
from gaussian_splatting_web_tpu.core import camera as jax_camera
from gaussian_splatting_web_tpu.core.types import numpy_cloud
from gaussian_splatting_web_tpu.ops.projection import (
    project_gaussians as jax_project,
)
from gaussian_splatting_web_tpu.ops.rasterize import render_impl as jax_render
from gaussian_splatting_web_tpu.ops.sort import bin_splats as jax_bin
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core import camera as port_camera
from gaussian_splatting_web_tpu_torch.core.types import GaussianCloud
from gaussian_splatting_web_tpu_torch.ops.projection import ProjectedSplats
from gaussian_splatting_web_tpu_torch.ops.rasterize import render
from gaussian_splatting_web_tpu_torch.ops.sort import bin_splats
from tests.conftest import assert_images_close

torch.set_num_threads(2)

W, H = 64, 64
CAP = RenderConfig(max_dup=16, max_per_tile=4096)
EYE = dict(eye=(0.0, 0.0, -6.0), center=(0.0, 0.0, 0.0))


def crowded_cloud(n=3000, seed=5):
    """`n` faint splats (opacity 0.006) about the frame's centre, each a
    few tiles wide: the central tiles hold more than 1,024 pairs, and a
    pixel there stays open (T above 1e-4) past its 1,024th pair."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return numpy_cloud(GaussianCloud(
        xyz=rng.normal(scale=0.15, size=(n, 3)).astype(np.float32),
        log_scale=rng.uniform(-2.0, -1.6, size=(n, 3)).astype(np.float32),
        quat=q,
        opacity_logit=np.full((n,), np.log(0.006 / 0.994), np.float32),
        sh=rng.normal(scale=0.3, size=(n, 1, 3)).astype(np.float32)))


def test_binning_above_1024_matches_jax_and_plain_twin():
    cloud = crowded_cloud()
    jcfg = JaxConfig(**dataclasses.asdict(CAP))
    ref_splats = jax_project(cloud, jax_camera.default_camera(W, H, **EYE),
                             W, H, jcfg)
    splats = ProjectedSplats(**{
        f.name: torch.from_numpy(np.array(getattr(ref_splats, f.name)))
        for f in dataclasses.fields(ProjectedSplats)})
    ref = jax_bin(ref_splats, W, H, jcfg)
    got = bin_splats(splats, W, H, CAP)
    count = np.asarray(ref.tile_count)
    assert count.max() > 1024 and count.max() <= CAP.max_per_tile
    np.testing.assert_array_equal(got.tile_count.numpy(), count)
    np.testing.assert_array_equal(got.tile_start.numpy(),
                                  np.asarray(ref.tile_start))
    assert int(got.overflow) == int(ref.overflow) == 0
    # the crowded tile's whole segment, in the same depth order
    t = int(count.argmax())
    s = int(got.tile_start[t])
    seg = slice(s, s + int(count[t]))
    np.testing.assert_array_equal(got.sorted_gidx[seg].numpy(),
                                  np.asarray(ref.sorted_gidx)[seg])

    port = GaussianCloud.from_numpy(cloud)
    cam = port_camera.default_camera(W, H, **EYE)
    img, aux = render(port, cam, W, H, CAP)
    img0, _ = jax_render(cloud, jax_camera.default_camera(W, H, **EYE), W, H,
                         jcfg)
    assert_images_close(img.numpy(), np.asarray(img0))
    assert float(aux["alpha"].max()) > 0.5
    # the shipped cap cuts the crowded tiles' pairs: the frame moves
    cut, _ = render(port, cam, W, H, CAP.replace(max_per_tile=1024))
    assert float((cut - img).abs().max()) > 1e-3
