"""Kernels A and B on the card vs their plain PyTorch twins, at small
sizes (including the adversarial scene of their footprint cull), and the
launches of a render and of a training step.

Marked `gpu`: every test skips without a CUDA device. The file imports
neither jax nor tests/conftest.py, so it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from gaussian_splatting_web_tpu_torch.bench_lib import (
    grad_parity,
    grad_parity_ok,
    make_adversarial_scene,
    make_scene,
)
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core import camera as cam
from gaussian_splatting_web_tpu_torch.core.types import GaussianCloud
from gaussian_splatting_web_tpu_torch.ops.cuda import raster as raster_cuda
from gaussian_splatting_web_tpu_torch.ops.projection import project_gaussians
from gaussian_splatting_web_tpu_torch.ops.rasterize import (
    composite_backward_plain,
    composite_image_plain,
    fold_pair_grads,
    pack_splat_fields,
    render,
)
from gaussian_splatting_web_tpu_torch.ops.sort import bin_splats

pytestmark = pytest.mark.gpu

CFG = RenderConfig(max_dup=16, max_per_tile=256)
# the repo's image rule (tests/conftest.py::assert_images_close)
ATOL, MAX_BAD_FRAC = 2e-4, 2e-4
FIELDS = ("xyz", "log_scale", "quat", "opacity_logit", "sh")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scene(seed, n=150, opaque=False):
    cloud = make_scene(n, seed=seed, sh_degree=1,
                       log_scale_range=(-3.5, -1.5), device="cpu")
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


def test_kernel_adversarial_scene(device):
    """Needles, centres off the frame, opacities at the cutoff, sub-pixel
    splats and splats past max_dup: the image rule and last_idx."""
    out = _kernel_vs_plain(make_adversarial_scene(device="cpu"), 96, 64,
                           device)
    assert out.alpha.max().item() > 0.3


def test_render_launches_kernel_once_per_frame(device):
    cloud = _scene(2).to(device)
    camera = cam.default_camera(64, 48, eye=(0, 0, -6), center=(0, 0, 0))
    raster_cuda.launches = 0
    for _ in range(3):
        img, _ = render(cloud, camera, 64, 48, CFG)
    torch.cuda.synchronize()
    assert raster_cuda.launches == 3
    assert img.device.type == "cuda" and torch.isfinite(img).all()


def _backward_vs_plain(cloud, w, h, dev, cfg=CFG):
    """Kernel B against its plain twin on the same bins, residual and
    cotangents, after the fold: the scale-relative gradient rule."""
    camera = cam.default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    splats = project_gaussians(cloud.to(dev), camera.to(dev), w, h, cfg)
    bins = bin_splats(splats, w, h, cfg)
    fields = pack_splat_fields(splats)
    fwd = raster_cuda.composite_image(fields, bins, w, h, cfg)
    gen = torch.Generator().manual_seed(0)
    d_rgb = torch.randn((h, w, 3), generator=gen).to(dev)
    d_alpha = torch.randn((h, w), generator=gen).to(dev)
    got = raster_cuda.composite_backward(fields, bins, w, h, cfg, fwd, d_rgb,
                                         d_alpha)
    again = raster_cuda.composite_backward(fields, bins, w, h, cfg, fwd,
                                           d_rgb, d_alpha)
    want = composite_backward_plain(fields, bins, w, h, cfg, fwd, d_rgb,
                                    d_alpha)
    torch.cuda.synchronize()
    assert torch.equal(got, again)            # bitwise repeatable
    n = fields.shape[0]
    g_got = fold_pair_grads(got, bins, n)
    g_want = fold_pair_grads(want, bins, n)
    stats = grad_parity(g_got.T, g_want.T)
    # f32 sums in another order; discrete flips bounded in count
    assert grad_parity_ok(stats, extra=2), stats
    assert torch.isfinite(got).all() and g_want.abs().max() > 0
    return stats


@pytest.mark.parametrize("seed", [0, 1])
def test_backward_kernel_matches_plain(device, seed):
    _backward_vs_plain(_scene(seed), 64, 48, device)


def test_backward_kernel_early_exit_scene(device):
    _backward_vs_plain(_scene(5, n=40, opaque=True), 48, 48, device)


def test_backward_kernel_ragged_frame_and_cap(device):
    _backward_vs_plain(_scene(3, n=200), 72, 40, device,
                       cfg=CFG.replace(max_per_tile=32))


def test_backward_kernel_adversarial_scene(device):
    _backward_vs_plain(make_adversarial_scene(device="cpu"), 96, 64, device)


def test_kernels_schedule_tiles_heavy_first(device):
    """A and B write the heavy-first schedule before they composite: a
    permutation of the tiles whose capped pair counts fall along it, as in
    the plain twin `tile_order` (the kernel may order ties otherwise)."""
    cfg = CFG.replace(max_per_tile=32)
    w, h = 72, 40
    camera = cam.default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    splats = project_gaussians(_scene(3, n=200).to(device), camera.to(device),
                               w, h, cfg)
    bins = bin_splats(splats, w, h, cfg)
    fields = pack_splat_fields(splats)
    assert int(bins.tile_count.max()) > cfg.max_per_tile
    capped = torch.clamp(bins.tile_count, max=cfg.max_per_tile)
    want = capped[raster_cuda.tile_order(bins, cfg).long()]
    run, (fwd, order) = raster_cuda.prepare_fwd(fields, bins, w, h, cfg)
    run()
    run_b, (_, order_b) = raster_cuda.prepare_bwd(
        fields, bins, w, h, cfg, fwd, torch.ones((h, w, 3), device=device),
        torch.ones((h, w), device=device))
    run_b()
    torch.cuda.synchronize()
    for got in (order, order_b):
        assert sorted(got.tolist()) == list(range(bins.tile_count.shape[0]))
        assert torch.equal(capped[got.long()], want)


def test_grads_flow_through_kernels(device):
    """render on the card is differentiable: A forward, B backward, once
    each, and the parameter gradients agree with the CPU path's."""
    cpu = _scene(0)
    camera = cam.default_camera(64, 48, eye=(0, 0, -6), center=(0, 0, 0))
    grads = []
    for dev in (torch.device("cpu"), device):
        cloud = GaussianCloud(**{
            f: getattr(cpu, f).clone().to(dev).requires_grad_(True)
            for f in FIELDS})
        raster_cuda.launches = raster_cuda.launches_bwd = 0
        img, _ = render(cloud, camera, 64, 48, CFG)
        (img * img).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert raster_cuda.launches == raster_cuda.launches_bwd == 1
        else:
            assert raster_cuda.launches == raster_cuda.launches_bwd == 0
        grads.append([getattr(cloud, f).grad for f in FIELDS])
    for g in grads[1]:
        assert torch.isfinite(g).all()
    assert grad_parity_ok(grad_parity(grads[1], grads[0]), extra=2)


def test_train_step_launches_each_kernel_once(device):
    from gaussian_splatting_web_tpu_torch.models.gaussian_model import (
        GaussianModel,
    )
    from gaussian_splatting_web_tpu_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    camera = cam.default_camera(64, 48, eye=(0, 0, -6), center=(0, 0, 0))
    with torch.no_grad():
        target, _ = render(_scene(1).to(device), camera, 64, 48, CFG)
    model = GaussianModel.from_cloud(_scene(0)).to(device)
    state = TrainState(model, make_optimizer(model))
    step = make_train_step(64, 48, CFG)
    raster_cuda.launches = raster_cuda.launches_bwd = 0
    losses = [float(step(state, camera, target)[1]) for _ in range(3)]
    torch.cuda.synchronize()
    assert raster_cuda.launches == raster_cuda.launches_bwd == 3
    assert all(np.isfinite(losses)) and state.step == 3


# --- kernels C and D (anchor binning) -------------------------------------

ACFG = CFG.replace(binning="anchor")


def _crowded_scene():
    """2500 small splats over the central tiles: ranges overrun their
    aligned cover and tiles hold more than k_cap candidates."""
    cloud = make_scene(2500, seed=9, sh_degree=0,
                       log_scale_range=(-3.5, -1.5), device="cpu")
    cloud.xyz = cloud.xyz * 0.15
    return cloud


def _anchor_vs_plain(cloud, w, h, dev, cfg=ACFG):
    """Kernel C against its plain version (image rule, identical ordered
    lists), then D against its plain version after the fold (gradient
    rule), D bitwise repeatable."""
    from gaussian_splatting_web_tpu_torch.ops import anchor
    from gaussian_splatting_web_tpu_torch.ops.cuda import anchor as anchor_cuda

    camera = cam.default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    splats = project_gaussians(cloud.to(dev), camera.to(dev), w, h, cfg)
    abins = anchor.bin_splats_anchor(splats, w, h, cfg)
    fields = pack_splat_fields(splats)
    got, merge = anchor_cuda.composite_anchor(fields, abins, w, h, cfg)
    want, want_merge = anchor.composite_anchor_plain(fields, abins, w, h, cfg)
    torch.cuda.synchronize()
    for a, b in zip(merge, want_merge):
        assert torch.equal(a, b)
    img = torch.cat([got.rgb, got.alpha[..., None]], -1)
    ref = torch.cat([want.rgb, want.alpha[..., None]], -1)
    bad = (img - ref).abs().amax(-1) > ATOL
    assert bad.float().mean().item() <= MAX_BAD_FRAC, int(bad.sum())
    assert (got.final_log_t - want.final_log_t).abs()[~bad].max() <= 1e-4

    gen = torch.Generator().manual_seed(0)
    d_rgb = torch.randn((h, w, 3), generator=gen).to(dev)
    d_alpha = torch.randn((h, w), generator=gen).to(dev)
    dp = anchor_cuda.composite_anchor_backward(fields, abins, w, h, cfg, got,
                                               merge, d_rgb, d_alpha)
    again = anchor_cuda.composite_anchor_backward(fields, abins, w, h, cfg,
                                                  got, merge, d_rgb, d_alpha)
    dp_plain = anchor.composite_anchor_backward_plain(
        fields, abins, w, h, cfg, got, d_rgb, d_alpha)
    torch.cuda.synchronize()
    assert torch.equal(dp, again)
    n = fields.shape[0]
    g_got = anchor.fold_anchor_grads(dp, abins, n)
    g_want = anchor.fold_anchor_grads(dp_plain, abins, n)
    assert torch.isfinite(g_got).all() and g_want.abs().max() > 0
    assert grad_parity_ok(grad_parity(g_got.T, g_want.T), extra=2)
    return abins, merge


@pytest.mark.parametrize("scene", ["random", "opaque", "crowded"])
def test_anchor_kernels_match_plain(device, scene):
    from gaussian_splatting_web_tpu_torch.ops import anchor

    cloud = {"random": lambda: _scene(0), "crowded": _crowded_scene,
             "opaque": lambda: _scene(5, n=40, opaque=True)}[scene]()
    abins, merge = _anchor_vs_plain(cloud, 64, 48, device)
    if scene == "crowded":
        rng = anchor.tile_ranges(abins, 4, 3, ACFG)
        half = anchor.c_max(ACFG) * anchor.KCL
        assert int((rng.s1 - rng.base).max()) > half
        assert int(merge.k_used.max()) == anchor.k_cap(ACFG)


def test_anchor_grads_flow_through_kernels(device):
    """render with binning='anchor' on the card: C forward and D backward
    once each, none of A or B, and the parameter gradients agree with the
    CPU path's."""
    from gaussian_splatting_web_tpu_torch.ops.cuda import anchor as anchor_cuda

    cpu = _scene(0)
    camera = cam.default_camera(64, 48, eye=(0, 0, -6), center=(0, 0, 0))
    grads = []
    for dev in (torch.device("cpu"), device):
        cloud = GaussianCloud(**{
            f: getattr(cpu, f).clone().to(dev).requires_grad_(True)
            for f in FIELDS})
        raster_cuda.launches = raster_cuda.launches_bwd = 0
        anchor_cuda.launches = anchor_cuda.launches_bwd = 0
        img, _ = render(cloud, camera, 64, 48, ACFG)
        (img * img).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        want = 1 if dev.type == "cuda" else 0
        assert anchor_cuda.launches == anchor_cuda.launches_bwd == want
        assert raster_cuda.launches == raster_cuda.launches_bwd == 0
        grads.append([getattr(cloud, f).grad for f in FIELDS])
    for g in grads[1]:
        assert torch.isfinite(g).all()
    assert grad_parity_ok(grad_parity(grads[1], grads[0]), extra=2)


def test_anchor_kernel_shared_memory_caps(device):
    """A cap whose merge keys need more than 48 KB of shared memory takes
    the opt-in (max_per_tile=2048: 8,192 keys, 74.7 KB) and still matches
    the plain version; one past the 227 KB a block can hold is refused."""
    from gaussian_splatting_web_tpu_torch.ops import anchor
    from gaussian_splatting_web_tpu_torch.ops.cuda import anchor as anchor_cuda

    cfg = ACFG.replace(max_per_tile=2048)
    assert anchor_cuda.merge_smem_bytes(cfg) > 48 * 1024
    _, merge = _anchor_vs_plain(_crowded_scene(), 64, 48, device, cfg=cfg)
    assert int(merge.k_used.max()) == anchor.k_cap(cfg)

    big = ACFG.replace(max_per_tile=8192)
    camera = cam.default_camera(64, 48, eye=(0, 0, -6), center=(0, 0, 0))
    splats = project_gaussians(_scene(0).to(device), camera.to(device), 64,
                               48, big)
    abins = anchor.bin_splats_anchor(splats, 64, 48, big)
    with pytest.raises(ValueError, match="shared memory"):
        anchor_cuda.composite_anchor(pack_splat_fields(splats), abins, 64,
                                     48, big)
