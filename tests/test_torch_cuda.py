"""Kernels A-D on the card vs their plain PyTorch twins, at small sizes
(including the adversarial scene of their footprint cull), their tile
schedules, and the launches of a render and of a training step; A's and B's
tile-list entries (E) against the full-frame kernels and the list twins;
the same under the JAX package's packed modes (CFG_P: A-E with the mean16
flag on tiered bins, C and D on packed anchor bins); the bench's gate and
its scaled-gradient mutant, and the PLY unpack built on the machine.

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
from gaussian_splatting_web_tpu_torch.ops.cuda import build
from gaussian_splatting_web_tpu_torch.ops.cuda import raster as raster_cuda
from gaussian_splatting_web_tpu_torch.ops.projection import project_gaussians
from gaussian_splatting_web_tpu_torch.ops.rasterize import (
    assemble_image,
    composite_backward_plain,
    composite_image_plain,
    composite_tiles,
    composite_tiles_backward_plain,
    fold_pair_grads,
    pack_splat_fields,
    render,
    tile_major,
)
from gaussian_splatting_web_tpu_torch.ops.sort import bin_splats
from gaussian_splatting_web_tpu_torch.parallel.render_sharded import (
    shard_tile_ids,
)

pytestmark = pytest.mark.gpu

CFG = RenderConfig(max_dup=16, max_per_tile=256)
CFG_P = CFG.replace(depth_bits=19, tier_split=2, pack_fields=True,
                    pack_mean16=True, pack_grads=True)
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
    fields = pack_splat_fields(splats, cfg)
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
    build.reset_launches()
    for _ in range(3):
        img, _ = render(cloud, camera, 64, 48, CFG)
    torch.cuda.synchronize()
    assert build.launch_counts()["A"] == 3
    assert img.device.type == "cuda" and torch.isfinite(img).all()


def _backward_vs_plain(cloud, w, h, dev, cfg=CFG):
    """Kernel B against its plain twin on the same bins, residual and
    cotangents, after the fold: the scale-relative gradient rule."""
    camera = cam.default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    splats = project_gaussians(cloud.to(dev), camera.to(dev), w, h, cfg)
    bins = bin_splats(splats, w, h, cfg)
    fields = pack_splat_fields(splats, cfg)
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
    g_got = fold_pair_grads(got, bins, n, cfg)
    g_want = fold_pair_grads(want, bins, n, cfg)
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
    fields = pack_splat_fields(splats, cfg)
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


def _tiles_vs_full(cloud, w, h, dev, cfg=CFG, n_shards=3, chunk=2):
    """Kernels A's and B's tile-list entries over the sentinel-padded
    strips of `n_shards` tile shards: the stitched tiles equal full-frame
    A's image and residual bit for bit, the sentinel slots are empty, and
    the strips' B rows add up to full-frame B's bit for bit (each pair's
    row comes from one strip); on each strip, A against the list twin by
    the image rule on the pixels inside the frame and B against the list
    twin after the fold by the gradient rule."""
    camera = cam.default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    splats = project_gaussians(cloud.to(dev), camera.to(dev), w, h, cfg)
    bins = bin_splats(splats, w, h, cfg)
    fields = pack_splat_fields(splats, cfg)
    gx, gy = cfg.grid_size(w, h)
    t = gx * gy
    full = raster_cuda.composite_image(fields, bins, w, h, cfg)
    gen = torch.Generator().manual_seed(0)
    d_rgb = torch.randn((h, w, 3), generator=gen).to(dev)
    d_alpha = torch.randn((h, w), generator=gen).to(dev)
    rows_full = raster_cuda.composite_backward(fields, bins, w, h, cfg, full,
                                               d_rgb, d_alpha)
    cot = tile_major(torch.cat([d_rgb, d_alpha[..., None]], -1), gx, gy, 16)
    inside = tile_major(torch.ones((h, w, 1), device=dev), gx, gy,
                        16)[..., 0] > 0
    stitched = torch.zeros((t, 256, 6), device=dev)
    rows = torch.zeros_like(rows_full)
    n = fields.shape[0]
    for s in range(n_shards):
        ids = shard_tile_ids(t, n_shards, chunk, s).to(dev)
        real = ids < t
        out = raster_cuda.composite_forward(fields, bins, w, h, cfg,
                                            tile_ids=ids)
        assert not out.rgba[~real].any() and not out.final_log_t[~real].any()
        assert (out.last_idx[~real] == -1).all()
        stitched[ids[real].long()] = torch.cat(
            [out.rgba, out.final_log_t[..., None],
             out.last_idx[..., None].float()], -1)[real]
        rgba, _, _ = composite_tiles(fields, bins, ids, gx, cfg)
        keep = inside[ids.clamp(max=t - 1).long()] & real[:, None]
        bad = (out.rgba - rgba).abs().amax(-1)[keep] > ATOL
        assert bad.float().mean().item() <= MAX_BAD_FRAC, int(bad.sum())
        d_list = torch.where(real[:, None, None],
                             cot[ids.clamp(max=t - 1).long()], 0.0)
        part = raster_cuda.composite_backward(fields, bins, w, h, cfg, out,
                                              d_list, tile_ids=ids)
        rows += part
        want = composite_tiles_backward_plain(fields, bins, ids, w, h, cfg,
                                              out.last_idx, d_list)
        stats = grad_parity(fold_pair_grads(part, bins, n, cfg).T,
                            fold_pair_grads(want, bins, n, cfg).T)
        assert grad_parity_ok(stats, extra=2), stats
    torch.cuda.synchronize()
    img = assemble_image(stitched, w, h, gx, gy)
    assert torch.equal(img[..., :3], full.rgb)
    assert torch.equal(img[..., 3], full.alpha)
    assert torch.equal(img[..., 4], full.final_log_t)
    assert torch.equal(img[..., 5].int(), full.last_idx)
    assert torch.equal(rows, rows_full) and rows.abs().max() > 0


@pytest.mark.parametrize("scene", ["random", "opaque", "ragged",
                                   "adversarial"])
def test_tile_list_kernels_match_full_frame_and_plain(device, scene):
    if scene == "random":
        _tiles_vs_full(_scene(0), 64, 48, device)
    elif scene == "opaque":
        _tiles_vs_full(_scene(5, n=40, opaque=True), 48, 48, device,
                       n_shards=2)
    elif scene == "ragged":
        _tiles_vs_full(_scene(3, n=200), 72, 40, device,
                       cfg=CFG.replace(max_per_tile=32), n_shards=4)
    else:
        _tiles_vs_full(make_adversarial_scene(device="cpu"), 96, 64, device,
                       n_shards=5, chunk=1)


def test_tile_list_autograd_launches_and_schedule(device):
    """composite_tiles_subset on the card: E-A forward and E-B backward once
    each, and no A or B; over every tile, CompositeFn's gradient through
    the tile list equals its gradient over the frame bit for bit; both
    entries write a heavy-first schedule of the list positions."""
    w, h = 72, 40
    cfg = CFG.replace(max_per_tile=32)
    camera = cam.default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    splats = project_gaussians(_scene(3, n=200).to(device), camera.to(device),
                               w, h, cfg)
    bins = bin_splats(splats, w, h, cfg)
    fields = pack_splat_fields(splats).detach().requires_grad_(True)
    gx, gy = cfg.grid_size(w, h)
    t = gx * gy
    weight = torch.rand((h, w, 4), generator=torch.Generator().manual_seed(1)
                        ).to(device)
    full = raster_cuda.composite_image(fields, bins, w, h, cfg)
    (g_full,) = torch.autograd.grad(
        (torch.cat([full.rgb, full.alpha[..., None]], -1) * weight).sum(),
        fields)
    ids = torch.cat([torch.arange(t), torch.full((3,), t)]).int().to(device)
    build.reset_launches()
    tiles = raster_cuda.composite_tiles_subset(fields, bins, ids, w, h, cfg)
    img = assemble_image(tiles[:t], w, h, gx, gy)
    (g_list,) = torch.autograd.grad((img * weight).sum(), fields)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    assert counts["E-A"] == 1 and counts["E-B"] == 1
    assert counts["A"] == counts["B"] == 0
    assert torch.equal(g_list, g_full)

    run, (out, order) = raster_cuda.prepare_fwd(fields.detach(), bins, w, h,
                                                cfg, tile_ids=ids)
    run()
    run_b, (_, order_b) = raster_cuda.prepare_bwd(
        fields.detach(), bins, w, h, cfg, out,
        torch.ones((ids.shape[0], 256, 4), device=device), tile_ids=ids)
    run_b()
    torch.cuda.synchronize()
    capped = torch.clamp(torch.nn.functional.pad(bins.tile_count, (0, 1)),
                         max=cfg.max_per_tile)[ids.long()]
    want = capped[raster_cuda.tile_list_order(bins, ids, cfg).long()]
    for got in (order, order_b):
        assert sorted(got.tolist()) == list(range(ids.shape[0]))
        assert torch.equal(capped[got.long()], want)
    with pytest.raises(ValueError, match="more than once"):
        raster_cuda.composite_forward(fields.detach(), bins, w, h, cfg,
                                      tile_ids=torch.cat([ids, ids[:1]]))


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
        build.reset_launches()
        img, _ = render(cloud, camera, 64, 48, CFG)
        (img * img).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        counts = build.launch_counts()
        want = 1 if dev.type == "cuda" else 0
        assert counts["A"] == counts["B"] == want
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
    build.reset_launches()
    losses = [float(step(state, camera, target)[1]) for _ in range(3)]
    torch.cuda.synchronize()
    counts = build.launch_counts()
    assert counts["A"] == counts["B"] == counts["adam"] == 3
    assert all(np.isfinite(losses)) and state.step == 3


# --- kernels C and D (anchor binning) -------------------------------------

ACFG = CFG.replace(binning="anchor")


def _crowded_scene(seed=9, spread=0.15):
    """2500 small splats over the central tiles: ranges overrun their
    aligned cover and tiles hold more than k_cap candidates."""
    cloud = make_scene(2500, seed=seed, sh_degree=0,
                       log_scale_range=(-3.5, -1.5), device="cpu")
    cloud.xyz = cloud.xyz * spread
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
    fields = pack_splat_fields(splats, cfg)
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
    g_got = anchor.fold_anchor_grads(dp, abins, n, cfg)
    g_want = anchor.fold_anchor_grads(dp_plain, abins, n, cfg)
    assert torch.isfinite(g_got).all() and g_want.abs().max() > 0
    assert grad_parity_ok(grad_parity(g_got.T, g_want.T), extra=2)
    return abins, merge


@pytest.mark.parametrize("scene", ["random", "opaque", "crowded",
                                   "adversarial", "column-overrun"])
def test_anchor_kernels_match_plain(device, scene):
    from gaussian_splatting_web_tpu_torch.ops import anchor

    if scene == "column-overrun":
        # a range A splits its columns past its cover while range B holds
        # candidates below that split (max_per_tile 64: 512-lane covers)
        cfg = ACFG.replace(max_per_tile=64)
        abins, _ = _anchor_vs_plain(_crowded_scene(seed=1, spread=0.25), 64,
                                    48, device, cfg=cfg)
        assert bool(anchor.split_overruns(abins, 4, 3, cfg).any())
        return
    if scene == "adversarial":
        abins, _ = _anchor_vs_plain(make_adversarial_scene(device="cpu"), 96,
                                    64, device)
        assert int(abins.overflow) > 0        # splats past max_dup
        return
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
    cpu = _scene(0)
    camera = cam.default_camera(64, 48, eye=(0, 0, -6), center=(0, 0, 0))
    grads = []
    for dev in (torch.device("cpu"), device):
        cloud = GaussianCloud(**{
            f: getattr(cpu, f).clone().to(dev).requires_grad_(True)
            for f in FIELDS})
        build.reset_launches()
        img, _ = render(cloud, camera, 64, 48, ACFG)
        (img * img).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        counts = build.launch_counts()
        want = 1 if dev.type == "cuda" else 0
        assert counts["C"] == counts["D"] == want
        assert counts["A"] == counts["B"] == 0
        grads.append([getattr(cloud, f).grad for f in FIELDS])
    for g in grads[1]:
        assert torch.isfinite(g).all()
    assert grad_parity_ok(grad_parity(grads[1], grads[0]), extra=2)


def test_anchor_kernel_shared_memory_caps(device):
    """A cap whose merge needs more than 48 KB of shared memory takes the
    opt-in (max_per_tile=2304: 5,632 union keys and a 2,304-lane ordered
    list, 54,272 bytes) and still matches the plain version; the first cap
    past the 227 KB a block can hold (11,264: 233,472 bytes) is refused."""
    from gaussian_splatting_web_tpu_torch.ops import anchor
    from gaussian_splatting_web_tpu_torch.ops.cuda import anchor as anchor_cuda

    cfg = ACFG.replace(max_per_tile=2304)
    assert anchor_cuda.merge_smem_bytes(cfg) > 48 * 1024
    _, merge = _anchor_vs_plain(_crowded_scene(), 64, 48, device, cfg=cfg)
    assert int(merge.k_used.max()) == anchor.k_cap(cfg)

    big = ACFG.replace(max_per_tile=11264)
    assert anchor_cuda.merge_smem_bytes(big) > anchor_cuda.MAX_SMEM_BYTES
    assert anchor_cuda.merge_smem_bytes(
        big.replace(max_per_tile=11008)) <= anchor_cuda.MAX_SMEM_BYTES
    camera = cam.default_camera(64, 48, eye=(0, 0, -6), center=(0, 0, 0))
    splats = project_gaussians(_scene(0).to(device), camera.to(device), 64,
                               48, big)
    abins = anchor.bin_splats_anchor(splats, 64, 48, big)
    with pytest.raises(ValueError, match="shared memory"):
        anchor_cuda.composite_anchor(pack_splat_fields(splats), abins, 64,
                                     48, big)


def test_anchor_kernels_schedule_tiles_heavy_first(device):
    """C and D write their heavy-first schedules before they run: each a
    permutation of the tiles whose weights fall along it as in the plain
    twins (C: the union positions its merge reads; D: the ordered lists'
    lengths), on the crowded scene whose weights hit both caps."""
    from gaussian_splatting_web_tpu_torch.ops import anchor
    from gaussian_splatting_web_tpu_torch.ops.cuda import anchor as anchor_cuda

    w, h = 64, 48
    gx, gy = ACFG.grid_size(w, h)
    camera = cam.default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    splats = project_gaussians(_crowded_scene().to(device), camera.to(device),
                               w, h, ACFG)
    abins = anchor.bin_splats_anchor(splats, w, h, ACFG)
    fields = pack_splat_fields(splats)
    run, (fwd, merge, order_c) = anchor_cuda.prepare_fwd(fields, abins, w, h,
                                                         ACFG)
    run()
    run_d, (_, order_d) = anchor_cuda.prepare_bwd(
        fields, abins, w, h, ACFG, fwd, merge,
        torch.ones((h, w, 3), device=device), torch.ones((h, w), device=device))
    run_d()
    torch.cuda.synchronize()
    weight_c, _ = anchor_cuda.schedule_weight(abins, gx, gy, ACFG)
    kc = anchor.k_cap(ACFG)
    for got, weight, want in (
            (order_c, weight_c, anchor_cuda.tile_order(abins, gx, gy, ACFG)),
            (order_d, merge.k_used,
             raster_cuda.heavy_first_order(merge.k_used, kc))):
        assert sorted(got.tolist()) == list(range(gx * gy))
        assert torch.equal(weight[got.long()], weight[want.long()])
    assert int(merge.k_used.max()) == kc


@pytest.mark.parametrize("banded,stream", [(False, "a2a"), (True, "a2a"),
                                           (True, "ring")])
def test_gaussian_sharded_step_is_deterministic(device, banded, stream):
    """A Gaussian-sharded step on the card (1 × 1 mesh, no process group)
    through E-A and E-B: two steps from the same state give the same
    gradient bits, and they equal the unsharded step's (the a2a way back
    copies each row gradient to its unique slot and sums the slot axis; no
    atomics)."""
    from gaussian_splatting_web_tpu_torch.models.gaussian_model import (
        PARAMS,
        GaussianModel,
    )
    from gaussian_splatting_web_tpu_torch.parallel import (
        make_gaussian_sharded_train_step,
        make_mesh,
    )
    from gaussian_splatting_web_tpu_torch.train.loss import photometric_loss
    from gaussian_splatting_web_tpu_torch.train.trainer import TrainState

    w, h = 64, 128
    cloud = _scene(4, n=2000).to(device)
    cams = [cam.default_camera(w, h, eye=(0, y, -6), center=(0, 0, 0)
                               ).to(device) for y in (0.0, 1.0)]
    with torch.no_grad():
        targets = torch.stack([0.8 * render(cloud, c, w, h, CFG)[0]
                               for c in cams])
    ref = GaussianModel.from_cloud(cloud)
    (sum(photometric_loss(render(ref.to_cloud(), c, w, h, CFG)[0], t)
         for c, t in zip(cams, targets)) / 2).backward()
    step = make_gaussian_sharded_train_step(w, h, make_mesh(), CFG,
                                            banded=banded, stream=stream)
    grads = []
    for _ in range(2):
        model = GaussianModel.from_cloud(cloud)
        build.reset_launches()
        step(TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3)),
             cams, targets)
        counts = build.launch_counts()
        assert (counts["E-A"], counts["E-B"]) == (2, 2)
        grads.append([getattr(model, f).grad for f in PARAMS])
    for f, a, b in zip(PARAMS, *grads):
        assert torch.equal(a, b), f
        assert torch.equal(a, getattr(ref, f).grad), f


# --- the packed modes (ROADMAP §1 item 12) ----------------------------------


@pytest.mark.parametrize("scene", ["random", "opaque", "ragged",
                                   "adversarial"])
def test_mean16_kernels_match_plain(device, scene):
    """A, B, E-A and E-B with the mean16 flag on tiered, packed-key bins of
    bf16 fields, against their twins (which quantize the same tile-local
    mean), after the tiered pack_grads fold; B bitwise repeatable."""
    cloud, w, h, cfg = {
        "random": (_scene(0), 64, 48, CFG_P),
        "opaque": (_scene(5, n=40, opaque=True), 48, 48, CFG_P),
        "ragged": (_scene(3, n=200), 72, 40, CFG_P.replace(max_per_tile=32)),
        "adversarial": (make_adversarial_scene(device="cpu"), 96, 64, CFG_P),
    }[scene]
    out = _kernel_vs_plain(cloud, w, h, device, cfg=cfg)
    assert out.alpha.max().item() > 0.3
    _backward_vs_plain(cloud, w, h, device, cfg=cfg)
    _tiles_vs_full(cloud, w, h, device, cfg=cfg, n_shards=3,
                   chunk=1 if scene == "adversarial" else 2)


def test_mean16_flag_changes_the_kernels_output(device):
    """The flag reaches the kernel: the same bins and fields composite
    otherwise without pack_mean16, as the twin does."""
    w, h = 64, 48
    camera = cam.default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    splats = project_gaussians(_scene(0).to(device), camera.to(device), w, h,
                               CFG_P)
    bins = bin_splats(splats, w, h, CFG_P)
    fields = pack_splat_fields(splats, CFG_P)
    off = CFG_P.replace(pack_mean16=False)
    a = raster_cuda.composite_image(fields, bins, w, h, CFG_P)
    b = raster_cuda.composite_image(fields, bins, w, h, off)
    want = composite_image_plain(fields, bins, w, h, off)
    torch.cuda.synchronize()
    assert not torch.equal(a.rgb, b.rgb)
    assert (b.rgb - want.rgb).abs().max().item() <= ATOL


@pytest.mark.parametrize("scene", ["random", "crowded", "adversarial",
                                   "column-overrun"])
def test_packed_anchor_kernels_match_plain(device, scene):
    """C and D on packed anchor bins (d16 keys, bf16 fields, pack_grads in
    the fold) against their plain versions: identical ordered lists, the
    image rule, the gradient rule, D bitwise repeatable."""
    from gaussian_splatting_web_tpu_torch.ops import anchor

    pcfg = ACFG.replace(pack_fields=True, pack_grads=True, pack_mean16=True)
    if scene == "column-overrun":
        cfg = pcfg.replace(max_per_tile=64)
        abins, _ = _anchor_vs_plain(_crowded_scene(seed=1, spread=0.25), 64,
                                    48, device, cfg=cfg)
        assert bool(anchor.split_overruns(abins, 4, 3, cfg).any())
        return
    if scene == "adversarial":
        _anchor_vs_plain(make_adversarial_scene(device="cpu"), 96, 64,
                         device, cfg=pcfg)
        return
    cloud = {"random": lambda: _scene(0), "crowded": _crowded_scene}[scene]()
    abins, merge = _anchor_vs_plain(cloud, 64, 48, device, cfg=pcfg)
    assert int(abins.sorted_depth.max()) <= 0xFFFF       # d16 keys
    if scene == "crowded":
        assert int(merge.k_used.max()) == anchor.k_cap(pcfg)


def test_packed_render_and_step_launch_counts(device):
    """render and a train step under CFG_P: A once per frame, A and B once
    per step; with the packed anchor binning C, and C and D; Adam once a
    step."""
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
    for cfg, fwd, bwd in ((CFG_P, "A", "B"),
                          (ACFG.replace(pack_fields=True, pack_grads=True),
                           "C", "D")):
        model = GaussianModel.from_cloud(_scene(0)).to(device)
        state = TrainState(model, make_optimizer(model))
        step = make_train_step(64, 48, cfg)
        build.reset_launches()
        with torch.no_grad():
            img, _ = render(model.to_cloud(), camera, 64, 48, cfg)
        losses = [float(step(state, camera, target)[1]) for _ in range(2)]
        torch.cuda.synchronize()
        counts = build.launch_counts()
        assert (counts[fwd], counts[bwd], counts["adam"]) == (3, 2, 2)
        assert all(np.isfinite(losses)) and torch.isfinite(img).all()


def test_bench_gate_green_and_scaled_kernel_red(device, monkeypatch):
    """`bench_lib.run` on the card: the gate (kernels A and B against their
    twins on the same bins) is green, every roofline share is in (0, 100],
    and with the kernel path's gradient scaled by 1.01 the gate is red."""
    from gaussian_splatting_web_tpu_torch import bench_lib

    result = bench_lib.run(n_synthetic=20_000, width=320, height=240,
                           emit_json=False)
    assert result["parity_gate_ok"] is True, result
    assert result["device"] == torch.cuda.get_device_name(0)
    assert all(0 < row["pct_roofline"] <= 100
               for row in result["roofline"].values())
    real = bench_lib._kernel_grads

    def scaled(*args):
        loss, grads = real(*args)
        return loss, [g * 1.01 for g in grads]

    monkeypatch.setattr(bench_lib, "_kernel_grads", scaled)
    camera = cam.default_camera(320, 240, eye=(0, 0, -8), center=(0, 0, 0))
    bad = bench_lib._grad_parity(make_scene(20_000, device=device),
                                 camera.to(device), 320, 240, RenderConfig())
    assert not bad["ok"], bad


def test_native_ply_read_equals_numpy(device, tmp_path):
    """The PLY unpack built on this machine (csrc/plyio.cpp) reads the same
    bits as the NumPy path."""
    from gaussian_splatting_web_tpu_torch.io.ply import read_ply, write_ply

    path = str(tmp_path / "scene.ply")
    write_ply(make_scene(10_000, seed=2, device="cpu"), path)
    native = read_ply(path, device=device, use_native=True)
    plain = read_ply(path, device=device, use_native=False)
    for f in FIELDS:
        assert torch.equal(getattr(native, f), getattr(plain, f)), f
