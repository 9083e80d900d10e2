"""Port compositor (the plain twin of kernel A) vs the JAX package's XLA
compositor `rasterize_tiles` AND the Pallas kernel A itself, run in
interpret mode on the CPU as tests/test_pallas.py runs it, on the same
bins. Also checks the per-pixel residual against a sequential loop, and
that a CPU tensor takes the plain path without touching the CUDA build."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from gaussian_splatting_web_tpu.config import RenderConfig as JaxConfig
from gaussian_splatting_web_tpu.core import camera as jax_camera
from gaussian_splatting_web_tpu.core.types import numpy_cloud
from gaussian_splatting_web_tpu.ops.pallas.raster import (
    rasterize_tiles_pallas,
)
from gaussian_splatting_web_tpu.ops.projection import (
    project_gaussians as jax_project,
)
from gaussian_splatting_web_tpu.ops.rasterize import (
    rasterize_tiles as jax_rasterize_tiles,
)
from gaussian_splatting_web_tpu.ops.sort import bin_splats as jax_bin
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.ops.cuda import build
from gaussian_splatting_web_tpu_torch.ops.cuda import raster as raster_cuda
from gaussian_splatting_web_tpu_torch.ops.projection import ProjectedSplats
from gaussian_splatting_web_tpu_torch.ops.rasterize import (
    pack_splat_fields,
    rasterize_tiles,
)
from gaussian_splatting_web_tpu_torch.ops.sort import TileBins
from tests.conftest import assert_images_close, make_random_cloud

torch.set_num_threads(2)

CFG = RenderConfig(max_dup=16, max_per_tile=256)


def _random_scene(seed, n=120, sh_degree=1, spread=1.0):
    return numpy_cloud(make_random_cloud(n, seed=seed, sh_degree=sh_degree,
                                         spread=spread))


def _opaque_scene():
    """Opaque stacked splats (cf. tests/test_pallas.py:43): every central
    pixel saturates and exits early."""
    n = 40
    cloud = numpy_cloud(make_random_cloud(n, seed=5, sh_degree=0))
    rng = np.random.default_rng(7)
    cloud.xyz = np.concatenate(
        [rng.normal(scale=0.05, size=(n, 2)), rng.uniform(-2, 2, (n, 1))],
        axis=1).astype(np.float32)
    cloud.opacity_logit = np.full((n,), 6.0, dtype=np.float32)
    cloud.log_scale = np.full((n, 3), -0.7, dtype=np.float32)
    return cloud


def _over_cap_scene():
    """200 splats packed into the centre so tiles exceed a 32-pair cap."""
    cloud = numpy_cloud(make_random_cloud(200, seed=8, sh_degree=0,
                                          spread=0.3))
    cloud.opacity_logit = np.full((200,), -2.5, dtype=np.float32)
    return cloud


def _bins(cloud, w, h, cfg):
    """JAX projection + binning, and the same splats and bins as port
    tensors."""
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    camera = jax_camera.default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    s = jax_project(cloud, camera, w, h, jcfg)
    b = jax_bin(s, w, h, jcfg)

    def t(a):
        return torch.from_numpy(np.array(a))

    splats = ProjectedSplats(**{f.name: t(getattr(s, f.name))
                                for f in dataclasses.fields(ProjectedSplats)})
    bins = TileBins(sorted_gidx=t(b.sorted_gidx), sorted_slot=t(b.sorted_slot),
                    tile_start=t(b.tile_start), tile_count=t(b.tile_count),
                    num_pairs=t(b.num_pairs), overflow=t(b.overflow))
    return s, b, jcfg, splats, bins


def _sequential_residual(splats, bins, w, h, cfg):
    """Independent per-pixel INRIA loop (pair by pair, f32 NumPy, power by
    the same tile-local bilinear form) → (alpha, final log-T, last
    contributing segment index) images."""
    gx, gy = cfg.grid_size(w, h)
    ts = cfg.tile_size
    f32 = np.float32
    f = pack_splat_fields(splats).numpy()
    gidx = bins.sorted_gidx.numpy()
    py, px = np.mgrid[0:ts, 0:ts].astype(f32)
    log_cut = f32(math.log(cfg.alpha_cutoff))
    log_eps = f32(math.log(cfg.transmittance_eps))
    alpha_img = np.zeros((gy * ts, gx * ts), f32)
    logt_img = np.zeros((gy * ts, gx * ts), f32)
    last_img = np.full((gy * ts, gx * ts), -1)
    for t in range(gx * gy):
        ox, oy = (t % gx) * ts, (t // gx) * ts
        logt = np.zeros((ts, ts), f32)
        acc = np.zeros((ts, ts), f32)
        last = np.full((ts, ts), -1)
        done = np.zeros((ts, ts), bool)
        start = int(bins.tile_start[t])
        for k in range(min(int(bins.tile_count[t]), cfg.max_per_tile)):
            mx, my, ca, cb, cc, _, _, _, op = f[gidx[start + k], :9]
            mx, my = mx - f32(ox), my - f32(oy)
            v0 = np.log(max(op, f32(1e-30))) - (
                f32(0.5) * ca * mx * mx + cb * mx * my
                + f32(0.5) * cc * my * my)
            power = (v0 + (ca * mx + cb * my) * px + (cc * my + cb * mx) * py
                     + (f32(-0.5) * ca) * (px * px)
                     + (f32(-0.5) * cc) * (py * py) + (-cb) * (px * py))
            a = np.where(power >= log_cut,
                         np.minimum(np.exp(power), f32(cfg.alpha_max)),
                         f32(0))
            incl = logt + np.log1p(-a)
            done |= incl < log_eps
            live = ~done & (a > 0)
            acc = np.where(live, acc + a * np.exp(logt), acc)
            logt = np.where(live, incl, logt)
            last = np.where(live, k, last)
        alpha_img[oy:oy + ts, ox:ox + ts] = acc
        logt_img[oy:oy + ts, ox:ox + ts] = logt
        last_img[oy:oy + ts, ox:ox + ts] = last
    return alpha_img[:h, :w], logt_img[:h, :w], last_img[:h, :w]


def _check(cloud, w, h, cfg, against_pallas=True):
    s, b, jcfg, splats, bins = _bins(cloud, w, h, cfg)
    out = rasterize_tiles(splats, bins, w, h, cfg)
    assert out.rgb.shape == (h, w, 3) and out.alpha.shape == (h, w)
    img = torch.cat([out.rgb, out.alpha[..., None]], -1).numpy()

    rgb0, a0 = jax_rasterize_tiles(s, b, w, h, jcfg)
    ref = np.concatenate([np.asarray(rgb0), np.asarray(a0)[..., None]], -1)
    assert_images_close(img, ref)
    if against_pallas:
        assert cfg.max_per_tile % 256 == 0   # the kernel's k_cap rounding
        rgb1, a1 = rasterize_tiles_pallas(s, b, w, h, jcfg, True)
        ref1 = np.concatenate([np.asarray(rgb1), np.asarray(a1)[..., None]],
                              -1)
        assert_images_close(img, ref1)

    alpha_seq, logt_seq, last_seq = _sequential_residual(splats, bins, w, h,
                                                         cfg)
    # f32 sums in another order: a few ulps of the accumulated values
    np.testing.assert_allclose(out.alpha.numpy(), alpha_seq, atol=1e-5)
    np.testing.assert_allclose(out.final_log_t.numpy(), logt_seq,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out.last_idx.numpy(), last_seq)
    return out, bins


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_compositor_matches_jax(seed):
    out, _ = _check(_random_scene(seed), 64, 48, CFG)
    assert out.alpha.max() > 0.3


def test_plain_compositor_early_exit_scene():
    out, _ = _check(_opaque_scene(), 48, 48, CFG)
    # saturated pixels stopped at the 1e-4 transmittance floor
    assert out.final_log_t.min() >= math.log(CFG.transmittance_eps)
    assert (out.alpha > 0.999).any()


def test_plain_compositor_tiles_over_cap():
    cfg = CFG.replace(max_per_tile=32)
    out, bins = _check(_over_cap_scene(), 64, 48, cfg, against_pallas=False)
    assert int(bins.tile_count.max()) > cfg.max_per_tile
    assert int(out.last_idx.max()) < cfg.max_per_tile


def test_plain_compositor_ragged_frame():
    """72x40: the last tile column and row are partial."""
    out, _ = _check(_random_scene(3, n=150, sh_degree=2, spread=2.5), 72, 40,
                    CFG)
    assert out.alpha[:, 64:].max() > 0 and out.alpha[32:, :].max() > 0


def test_cpu_tensor_takes_plain_path_without_build():
    cloud = _random_scene(4, n=30)
    _, _, _, splats, bins = _bins(cloud, 32, 32, CFG)
    build.reset_launches()
    out = raster_cuda.composite_image(pack_splat_fields(splats), bins, 32, 32,
                                      CFG)
    assert out.alpha.device.type == "cpu" and out.alpha.max() > 0
    assert build.launch_counts()["A"] == 0
    assert "raster_fwd" not in build._libs        # nothing was compiled
    with pytest.raises(ValueError, match="no compositor"):
        raster_cuda.composite_image(
            pack_splat_fields(splats).to("meta"), bins, 32, 32, CFG)
