"""Kernel A on the card vs its plain PyTorch twin, at small sizes.

Marked `gpu`: every test skips without a CUDA device. The file imports
neither jax nor tests/conftest.py, so it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from gaussian_splatting_web_tpu_torch.bench_lib import make_scene
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core import camera as cam
from gaussian_splatting_web_tpu_torch.ops.cuda import raster as raster_cuda
from gaussian_splatting_web_tpu_torch.ops.projection import project_gaussians
from gaussian_splatting_web_tpu_torch.ops.rasterize import (
    composite_image_plain,
    pack_splat_fields,
    render,
)
from gaussian_splatting_web_tpu_torch.ops.sort import bin_splats

pytestmark = pytest.mark.gpu

CFG = RenderConfig(max_dup=16, max_per_tile=256)
# the repo's image rule (tests/conftest.py::assert_images_close)
ATOL, MAX_BAD_FRAC = 2e-4, 2e-4


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scene(seed, n=150, opaque=False):
    cloud = make_scene(n, seed=seed, sh_degree=1,
                       log_scale_range=(-3.5, -1.5))
    if opaque:   # stacked opaque splats: every central pixel exits early
        rng = np.random.default_rng(seed)
        cloud.xyz = torch.from_numpy(np.concatenate(
            [rng.normal(scale=0.05, size=(n, 2)), rng.uniform(-2, 2, (n, 1))],
            axis=1).astype(np.float32))
        cloud.opacity_logit = torch.full((n,), 6.0)
        cloud.log_scale = torch.full((n, 3), -0.7)
    return cloud


def _kernel_vs_plain(cloud, w, h, dev, cfg=CFG):
    camera = cam.default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    splats = project_gaussians(cloud.to(dev), camera.to(dev), w, h, cfg)
    bins = bin_splats(splats, w, h, cfg)
    fields = pack_splat_fields(splats)
    got = raster_cuda.composite_image(fields, bins, w, h, cfg)
    want = composite_image_plain(fields, bins, w, h, cfg)
    torch.cuda.synchronize()
    img = torch.cat([got.rgb, got.alpha[..., None]], -1)
    ref = torch.cat([want.rgb, want.alpha[..., None]], -1)
    bad = (img - ref).abs().amax(-1) > ATOL
    assert bad.float().mean().item() <= MAX_BAD_FRAC, int(bad.sum())
    agree = ~bad
    dlog = (got.final_log_t - want.final_log_t).abs()[agree]
    assert dlog.max().item() <= 1e-4
    assert (got.last_idx != want.last_idx).float().mean().item() \
        <= MAX_BAD_FRAC
    return got


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_plain(device, seed):
    out = _kernel_vs_plain(_scene(seed), 64, 48, device)
    assert out.alpha.max().item() > 0.3


def test_kernel_early_exit_scene(device):
    out = _kernel_vs_plain(_scene(5, n=40, opaque=True), 48, 48, device)
    assert out.final_log_t.min().item() >= math.log(CFG.transmittance_eps)
    assert (out.alpha > 0.999).any()


def test_kernel_ragged_frame_and_cap(device):
    _kernel_vs_plain(_scene(3, n=200), 72, 40, device,
                     cfg=CFG.replace(max_per_tile=32))


def test_render_launches_kernel_once_per_frame(device):
    cloud = _scene(2).to(device)
    camera = cam.default_camera(64, 48, eye=(0, 0, -6), center=(0, 0, 0))
    raster_cuda.launches = 0
    for _ in range(3):
        img, _ = render(cloud, camera, 64, 48, CFG)
    torch.cuda.synchronize()
    assert raster_cuda.launches == 3
    assert img.device.type == "cuda" and torch.isfinite(img).all()


def test_kernel_refuses_grad(device):
    cloud = _scene(0).to(device)
    cloud.xyz.requires_grad_(True)
    camera = cam.default_camera(64, 48, eye=(0, 0, -6), center=(0, 0, 0))
    with pytest.raises(RuntimeError, match="forward-only"):
        render(cloud, camera, 64, 48, CFG)
