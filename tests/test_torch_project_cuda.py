"""Kernels P fwd and P bwd (`csrc/project.cu`) on the card against their
plain twins: the forward against `project_gaussians_plain` on the same
device, field by field, on an edge-case cloud at SH degrees 0-3 and on a
1M-Gaussian bench-distribution cloud at 1237x822; every input's gradient
against autograd of the forward twin in float64; the launch counters; no
host sync in a forward and backward; strided and misaligned inputs; a
float64 cloud cast to float32.

Marked `gpu`: every test skips without a CUDA device. The file imports
neither jax nor tests/conftest.py, so it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_project_cuda.py
"""

import dataclasses

import pytest
import torch

from gaussian_splatting_web_tpu_torch.bench_lib import (
    make_scene,
    projection_grad_parity,
    projection_grads_vs_f64,
    projection_parity,
)
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core import camera as cam
from gaussian_splatting_web_tpu_torch.core.types import GaussianCloud
from gaussian_splatting_web_tpu_torch.ops.cuda import project as project_cuda
from gaussian_splatting_web_tpu_torch.ops.projection import (
    project_gaussians,
    project_gaussians_plain,
)

pytestmark = pytest.mark.gpu

CFG = RenderConfig()
W, H = 72, 40
EYE = (0.2, 0.1, -6.0)
BIG_W, BIG_H = 1237, 822
INPUTS = ("xyz", "log_scale", "quat", "opacity_logit", "sh")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def edge_cloud(sh_degree, n=160, seed=0):
    """A small cloud (CPU) whose first rows sit behind the eye, straddle
    the clip_w > 0.2 cull, carry zero quaternions, fill the screen, are
    moved by the FOV clamp, and have rgb clamped at 0."""
    c = make_scene(n, seed=seed, sh_degree=sh_degree,
                   log_scale_range=(-3.5, -1.5), device="cpu")
    c.xyz *= 0.75
    c.xyz[0:3, 2] = torch.tensor([-7.0, -9.0, -6.5])
    c.xyz[3:6] = torch.tensor([[0.0, 0.0, -5.85], [0.1, 0.0, -5.79],
                               [0.0, 0.0, -5.8]])
    c.quat[6:9] = 0.0
    c.log_scale[9] = 1.5
    c.xyz[10] = torch.tensor([9.0, 0.3, -4.5])
    c.sh[11] = 0.0
    c.sh[11, 0] = torch.tensor([-5.0, 0.2, -5.0])
    return c


def big_cloud():
    return make_scene(1_000_000, seed=5, sh_degree=3, device="cpu")


def camera_for(w, h, eye):
    return cam.default_camera(w, h, eye=eye)


def on(cloud, dev, dtype=torch.float32):
    return GaussianCloud(**{f: getattr(cloud, f).to(dev, dtype)
                            for f in INPUTS})


def compare_forward(got, want, w, h, cfg):
    """`bench_lib.projection_parity`'s rule: every float field within
    PROJ_RTOL; radius and valid equal except by 1 where the twin's pre-ceil
    radius lies within PROJ_NEAR_INT of an integer, and valid except
    within PROJ_EDGE_PX of the frame's edge → the rows so excused."""
    parity = projection_parity(got, want, w, h, cfg)
    assert parity["ok"], parity
    return parity["excused"]


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_forward_matches_twin_edge_cases(device, sh_degree):
    cloud = on(edge_cloud(sh_degree), device)
    camera = camera_for(W, H, EYE).to(device)
    with torch.no_grad():
        got = project_gaussians(cloud, camera, W, H, CFG)
        want = project_gaussians_plain(cloud, camera, W, H, CFG)
    assert 0 < int(want.valid.sum()) < want.valid.numel()
    assert compare_forward(got, want, W, H, CFG) <= 1


def test_forward_matches_twin_1m(device):
    cloud = on(big_cloud(), device)
    camera = camera_for(BIG_W, BIG_H, (0.0, 0.0, -8.0)).to(device)
    with torch.no_grad():
        got = project_gaussians(cloud, camera, BIG_W, BIG_H, CFG)
        want = project_gaussians_plain(cloud, camera, BIG_W, BIG_H, CFG)
    excused = compare_forward(got, want, BIG_W, BIG_H, CFG)
    print(f"1M forward: {excused} rows excused, "
          f"{int(want.valid.sum())} valid")
    assert excused <= 100      # 1e-4 of the rows


def assert_grads_close(got, want, switch, label):
    """`bench_lib.projection_grad_parity`'s rule: row by row, on the rows
    off every switch point, |g - w| within 2e-3 of the row's norm plus 1e-6
    of the largest row's; the median row within 1e-5. At most 1e-4 of the
    rows lie on a switch point."""
    parity = projection_grad_parity(got, want, switch)
    for name, (mx, med) in parity["leaves"].items():
        print(f"{label} {name}: max rel {mx:.3e}, median {med:.3e}, "
              f"{parity['switch']} rows on a switch point")
    assert parity["ok"], parity


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_grads_match_f64_autograd_edge_cases(device, sh_degree):
    got, want, switch = projection_grads_vs_f64(
        edge_cloud(sh_degree), camera_for(W, H, EYE), W, H, CFG, device,
        seed=sh_degree)
    assert not switch[:12].any()   # the edge rows are meant to be checked
    assert_grads_close(got, want, switch, f"edge sh{sh_degree}")


def test_grads_match_f64_autograd_1m(device):
    got, want, switch = projection_grads_vs_f64(
        big_cloud(), camera_for(BIG_W, BIG_H, (0.0, 0.0, -8.0)), BIG_W,
        BIG_H, CFG, device, seed=7)
    assert_grads_close(got, want, switch, "1M")


def test_counters_count_one_launch_each(device):
    cloud = on(edge_cloud(3), device)
    leaves = {f: getattr(cloud, f).requires_grad_(True) for f in INPUTS}
    camera = camera_for(W, H, EYE).to(device)
    before = (project_cuda.launches, project_cuda.launches_bwd)
    out = project_gaussians(GaussianCloud(**leaves), camera, W, H, CFG)
    assert (project_cuda.launches - before[0],
            project_cuda.launches_bwd - before[1]) == (1, 0)
    (out.rgb.sum() + out.mean2d.sum() + out.conic.sum()
     + out.opacity.sum()).backward()
    assert (project_cuda.launches - before[0],
            project_cuda.launches_bwd - before[1]) == (1, 1)


def test_no_host_sync(device):
    cloud = on(edge_cloud(3), device)
    camera = camera_for(W, H, EYE).to(device)

    def fwd_bwd():
        leaves = {f: getattr(cloud, f).detach().requires_grad_(True)
                  for f in INPUTS}
        out = project_gaussians(GaussianCloud(**leaves), camera, W, H, CFG)
        return torch.autograd.grad(
            [out.mean2d, out.conic, out.rgb, out.opacity],
            [leaves[f] for f in INPUTS],
            [torch.ones_like(out.mean2d), torch.ones_like(out.conic),
             torch.ones_like(out.rgb), torch.ones_like(out.opacity)])

    fwd_bwd()                      # builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fwd_bwd()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("sh_degree", [2, 3])
def test_strided_and_misaligned_inputs(device, sh_degree):
    """Rows 1.. of a cloud (at SH degree 2 its SH rows start 108 bytes in:
    not 16-byte aligned) and transposed-layout xyz give the bits of the
    same rows laid out afresh."""
    full = on(edge_cloud(sh_degree, n=161), device)
    sliced = GaussianCloud(**{f: getattr(full, f)[1:] for f in INPUTS})
    sliced.xyz = sliced.xyz.T.contiguous().T
    fresh = GaussianCloud(**{f: getattr(sliced, f).contiguous().clone()
                             for f in INPUTS})
    camera = camera_for(W, H, EYE).to(device)
    with torch.no_grad():
        a = project_gaussians(sliced, camera, W, H, CFG)
        b = project_gaussians(fresh, camera, W, H, CFG)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def test_float64_cloud_is_cast_to_float32(device):
    """A float64 cloud runs the kernels on its float32 cast, as every
    storage dtype does: the bits of the float32 cloud, one launch."""
    cloud = edge_cloud(3)
    camera = camera_for(W, H, EYE).to(device)
    before = project_cuda.launches
    with torch.no_grad():
        a = project_gaussians(on(cloud, device, torch.float64), camera, W,
                              H, CFG)
        b = project_gaussians(on(cloud, device), camera, W, H, CFG)
    assert project_cuda.launches - before == 2
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
