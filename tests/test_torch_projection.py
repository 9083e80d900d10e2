"""Port projection + SH vs the JAX package's project_gaussians, every
ProjectedSplats field, SH degrees 0-3, with behind-camera, near-plane and
zero-quaternion rows; the hand-derived backward's plain twin against
autograd of the forward twin in float64, and `ProjectFn`'s CPU dispatch."""

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
from gaussian_splatting_web_tpu_torch.core.types import (
    CameraParams,
    GaussianCloud,
)
from gaussian_splatting_web_tpu_torch.ops.cuda import build
from gaussian_splatting_web_tpu_torch.ops.projection import (
    pack_camera,
    project_backward_plain,
    project_gaussians,
    project_gaussians_plain,
)
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


GRAD_OUTPUTS = ("mean2d", "conic", "depth", "rgb", "opacity")
INPUTS = ("xyz", "log_scale", "quat", "opacity_logit", "sh")


def branch_cloud(sh_degree, dtype):
    """`edge_case_cloud` plus a row the FOV clamp moves (in front, far off
    to the side) and a row whose rgb is clamped at 0, as a cloud of
    `dtype`."""
    cloud = edge_case_cloud(160, seed=30 + sh_degree, sh_degree=sh_degree)
    cloud.xyz[10] = [9.0, 0.3, -4.5]
    cloud.sh[11] = 0.0
    cloud.sh[11, 0] = [-5.0, 0.2, -5.0]
    port = GaussianCloud.from_numpy(cloud)
    return GaussianCloud(**{f: getattr(port, f).to(dtype) for f in INPUTS})


def camera_of(dtype):
    cam = port_camera.default_camera(W, H, eye=EYE)
    return CameraParams(**{f.name: getattr(cam, f.name).to(dtype)
                           for f in dataclasses.fields(cam)})


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
@pytest.mark.parametrize("absent", [(), ("depth", "opacity")])
def test_backward_plain_matches_autograd(sh_degree, absent):
    """project_backward_plain against autograd of project_gaussians_plain in
    float64: every input's gradient, on rows behind the camera, straddling
    the cull, with zero quaternions, screen-filling, FOV-clamped and with
    rgb clamped at 0; outputs whose gradient does not arrive are None."""
    f64 = torch.float64
    cloud, camera = branch_cloud(sh_degree, f64), camera_of(f64)
    leaves = {f: getattr(cloud, f).clone().requires_grad_(True)
              for f in INPUTS}
    out = project_gaussians_plain(GaussianCloud(**leaves), camera, W, H,
                                  RenderConfig())
    gen = torch.Generator().manual_seed(sh_degree)
    cot = {f: None if f in absent else
           torch.randn(getattr(out, f).shape, generator=gen, dtype=f64)
           for f in GRAD_OUTPUTS}
    want = torch.autograd.grad(
        [getattr(out, f) for f in GRAD_OUTPUTS if cot[f] is not None],
        [leaves[f] for f in INPUTS],
        [cot[f] for f in GRAD_OUTPUTS if cot[f] is not None],
        allow_unused=True)
    want = [torch.zeros_like(leaves[f]) if w is None else w
            for f, w in zip(INPUTS, want)]
    got = project_backward_plain(
        *(getattr(cloud, f) for f in INPUTS), pack_camera(camera, f64), W, H,
        RenderConfig(), *(cot[f] for f in GRAD_OUTPUTS))

    # the rows reach the branches they are there for
    t = cloud.xyz @ camera.view[:3, :3].T + camera.view[:3, 3]
    lim = RenderConfig().fov_clamp * camera.tan_half_fov[0]
    assert t[10, 2] > 0.2 and abs(t[10, 0] / t[10, 2]) > lim
    assert (out.rgb[11] == 0).any() and not out.valid[:3].any()
    for name, g, w in zip(INPUTS, got, want):
        assert g.shape == w.shape and g.dtype == f64, name
        scale = max(w.abs().max().item(), 1e-300)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-10 * scale, err_msg=name)


def test_project_fn_cpu_takes_the_twins():
    """On CPU tensors `project_gaussians` (through ProjectFn) gives the
    forward twin's outputs and the backward twin's gradients; the kernels'
    launch counters do not move."""
    before = build.launch_counts()
    cloud, camera = branch_cloud(3, torch.float32), camera_of(torch.float32)
    leaves = {f: getattr(cloud, f).clone().requires_grad_(True)
              for f in INPUTS}
    got = project_gaussians(GaussianCloud(**leaves), camera, W, H,
                            RenderConfig())
    want = project_gaussians_plain(cloud, camera, W, H, RenderConfig())
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), \
            f.name
    gen = torch.Generator().manual_seed(0)
    cot = [torch.randn(getattr(got, f).shape, generator=gen)
           for f in GRAD_OUTPUTS]
    grads = torch.autograd.grad([getattr(got, f) for f in GRAD_OUTPUTS],
                                [leaves[f] for f in INPUTS], cot)
    plain = project_backward_plain(
        *(getattr(cloud, f) for f in INPUTS), pack_camera(camera), W, H,
        RenderConfig(), *cot)
    for name, g, w in zip(INPUTS, grads, plain):
        assert torch.equal(g, w), name
    assert not got.radius.requires_grad and not got.valid.requires_grad
    after = build.launch_counts()
    assert (after["P"], after["P-bwd"]) == (before["P"], before["P-bwd"])


def test_camera_requiring_grad_raises():
    cloud, camera = branch_cloud(1, torch.float32), camera_of(torch.float32)
    camera.view.requires_grad_(True)
    with pytest.raises(ValueError, match="camera.view requires grad"):
        project_gaussians(cloud, camera, W, H, RenderConfig())
