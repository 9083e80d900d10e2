"""Port projection + SH vs the JAX package's project_gaussians, every
ProjectedSplats field, SH degrees 0-3, with behind-camera, near-plane and
zero-quaternion rows."""

import dataclasses

import numpy as np
import pytest
import torch

from gaussian_splatting_web_tpu.config import RenderConfig as JaxConfig
from gaussian_splatting_web_tpu.core import camera as jax_camera
from gaussian_splatting_web_tpu.core.types import numpy_cloud
from gaussian_splatting_web_tpu.ops.projection import (
    project_gaussians as jax_project,
)
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core import camera as port_camera
from gaussian_splatting_web_tpu_torch.core.types import GaussianCloud
from gaussian_splatting_web_tpu_torch.ops.projection import project_gaussians
from tests.conftest import make_random_cloud

torch.set_num_threads(2)

W, H = 72, 40
EYE = (0.2, 0.1, -6.0)
FIELDS = ("mean2d", "conic", "depth", "radius", "rgb", "opacity")


def edge_case_cloud(n, seed, sh_degree):
    """Random cloud whose first rows sit behind the camera, straddle the
    clip_w > 0.2 cull, or carry zero quaternions (dead padding rows)."""
    cloud = numpy_cloud(make_random_cloud(n, seed=seed, sh_degree=sh_degree,
                                          spread=1.5))
    cloud.xyz[0:3, 2] = [-7.0, -9.0, -6.5]          # behind the eye
    cloud.xyz[3:6] = [[0.0, 0.0, -5.85], [0.1, 0.0, -5.79], [0, 0, -5.8]]
    cloud.quat[6:9] = 0.0                           # zero quaternions
    cloud.log_scale[9] = 1.5                        # a screen-filling splat
    return cloud


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_projection_matches_jax(sh_degree):
    cloud = edge_case_cloud(160, seed=10 + sh_degree, sh_degree=sh_degree)
    cfg = RenderConfig()
    ref = jax_project(cloud, jax_camera.default_camera(W, H, eye=EYE), W, H,
                      JaxConfig(**dataclasses.asdict(cfg)))
    got = project_gaussians(GaussianCloud.from_numpy(cloud),
                            port_camera.default_camera(W, H, eye=EYE), W, H,
                            cfg)

    valid = np.asarray(ref.valid)
    assert 0 < valid.sum() < valid.size    # both culled and kept rows
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.radius.numpy(), np.asarray(ref.radius))
    for name in FIELDS:
        want = np.asarray(getattr(ref, name), np.float64)
        have = getattr(got, name).numpy().astype(np.float64)
        scale = np.abs(want).max()
        np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)
