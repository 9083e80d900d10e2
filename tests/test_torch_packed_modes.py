"""The packed and tiered binning modes of the port (ROADMAP §1 item 12) vs
the JAX package on the CPU, fed the same projected splats:

  * `quantize_bf16` / `quantize_mean16` against the JAX roundings, bit for
    bit, with their straight-through gradients;
  * `bin_splats` with the packed key (`depth_bits`), tiered duplication
    (with and without the middle tier, and with both tiers past their
    caps) and `tile_cull` (alone and with tiers): tile_start, tile_count,
    num_pairs and overflow exactly, the per-tile pair sets, and the live
    prefix of `sorted_slot` on scenes the test asserts to be free of tied
    keys; on a scene with ties, the sets and a non-decreasing key;
  * images and parameter gradients of `render` under `pack_fields` and
    `pack_fields + pack_mean16` against `jax.grad` of the JAX package's
    XLA `render_impl`, at SH 0 and 3;
  * `fold_pair_grads` with tiers and `pack_grads` against the JAX
    package's `_fold_pair_grads` on the same pair gradients;
  * the packed anchor binning against `bin_splats_anchor`, its forward
    against interpret-mode `rasterize_anchor`, and its gradients against
    `jax.grad` of the XLA dup path in the same rounding;
  * `--depth-bits` in the CLI.

Tolerances: images by the repo's image rule (`assert_images_close`, atol
2e-4 with 2e-4 of the pixels allowed past it) and gradients by
`bench_lib.grad_parity_ok` (p99 ≤ 1e-3 scale-relative), as in
tests/test_torch_grads.py; the anchor gradients by tests/test_anchor.py's
5e-4 + 1e-3·max rule; the fold at rtol 1e-5, atol 1e-6·max (f32 sums in
another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_web_tpu.config import RenderConfig as JaxConfig
from gaussian_splatting_web_tpu.core import camera as jax_camera
from gaussian_splatting_web_tpu.core.types import numpy_cloud
from gaussian_splatting_web_tpu.models.gaussian_model import (
    GaussianModel as JaxModel,
)
from gaussian_splatting_web_tpu.ops.pallas.anchor import (
    bin_splats_anchor as jax_bin_anchor,
)
from gaussian_splatting_web_tpu.ops.pallas.anchor import rasterize_anchor
from gaussian_splatting_web_tpu.ops.pallas.raster import _fold_pair_grads
from gaussian_splatting_web_tpu.ops.projection import (
    project_gaussians as jax_project,
)
from gaussian_splatting_web_tpu.ops.rasterize import (
    rasterize_tiles as jax_rasterize_tiles,
)
from gaussian_splatting_web_tpu.ops.rasterize import render_impl as jax_render
from gaussian_splatting_web_tpu.ops.sort import bin_splats as jax_bin
from gaussian_splatting_web_tpu.ops.sort import (
    quantize_bf16 as jax_quantize_bf16,
)
from gaussian_splatting_web_tpu.ops.sort import (
    quantize_mean16 as jax_quantize_mean16,
)
from gaussian_splatting_web_tpu.train.densify import (
    pad_to_capacity as jax_pad_to_capacity,
)
from gaussian_splatting_web_tpu_torch.bench_lib import (
    grad_parity,
    grad_parity_ok,
)
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core import camera as port_camera
from gaussian_splatting_web_tpu_torch.models.gaussian_model import (
    GaussianModel,
)
from gaussian_splatting_web_tpu_torch.ops import anchor
from gaussian_splatting_web_tpu_torch.ops.cuda import anchor as anchor_cuda
from gaussian_splatting_web_tpu_torch.ops.projection import ProjectedSplats
from gaussian_splatting_web_tpu_torch.ops.rasterize import (
    fold_pair_grads,
    pack_splat_fields,
    render,
)
from gaussian_splatting_web_tpu_torch.ops.sort import (
    bin_splats,
    float_to_sortable_uint,
    quantize_bf16,
    quantize_mean16,
    sort_key_bits,
)
from gaussian_splatting_web_tpu_torch.train.densify import pad_to_capacity
from tests.conftest import assert_images_close, make_random_cloud
from tests.test_torch_grads import numpy_cloud_model

torch.set_num_threads(2)

BASE = RenderConfig(max_dup=16, max_per_tile=256)
PACKED = dict(depth_bits=19, tier_split=2, pack_fields=True,
              pack_mean16=True, pack_grads=True)   # JAX's default values
SPLAT_FIELDS = (("mean2d", slice(0, 2)), ("conic", slice(2, 5)),
                ("rgb", slice(5, 8)), ("opacity", slice(8, 9)))


def _jcfg(cfg):
    return JaxConfig(**dataclasses.asdict(cfg))


# jitted: one compile costs less than the eager dispatch of every op
_jax_project = jax.jit(jax_project, static_argnums=(2, 3, 4))
_jax_bin = jax.jit(jax_bin, static_argnums=(1, 2, 3))
_jax_bin_anchor = jax.jit(jax_bin_anchor, static_argnums=(1, 2, 3))
_jax_fold = jax.jit(_fold_pair_grads, static_argnums=(2, 3))


def _scene(kind):
    """(numpy cloud, width, height). "overflow" puts more than 256 splats
    in both the middle tier's class and the big tier's at 128x96, past
    both tiers' 256-row floors; "ties" gives groups of splats one
    depth."""
    if kind == "plain":
        cloud = numpy_cloud(make_random_cloud(600, seed=2, sh_degree=0,
                                              spread=1.2))
        return _spaced(cloud), 64, 48
    if kind == "overflow":
        cloud = numpy_cloud(make_random_cloud(800, seed=4, sh_degree=0))
        cloud.log_scale[:300] = -1.9
        cloud.log_scale[300:600] = -0.9
        return _spaced(cloud), 128, 96
    assert kind == "ties"
    cloud = numpy_cloud(make_random_cloud(400, seed=6, sh_degree=0))
    cloud.xyz[:, 2] = np.round(cloud.xyz[:, 2] * 2) / 2    # 9 depth levels
    return cloud, 64, 48


def _spaced(cloud):
    """Depths 6 ± 1.8 at least 0.0045 apart: more than the packed key's
    19-bit resolution there (2⁻⁸ in [4, 8)), so no two pairs of a tile
    tie in it."""
    n = cloud.xyz.shape[0]
    rng = np.random.default_rng(n)
    cloud.xyz[:, 2] = rng.permutation(np.linspace(-1.8, 1.8, n)).astype(
        np.float32)
    return cloud


def _project(cloud, w, h, cfg):
    """The JAX projection, and the same splats as port tensors."""
    cam = jax_camera.default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    s = _jax_project(cloud, cam, w, h, _jcfg(cfg))
    splats = ProjectedSplats(**{
        f.name: torch.from_numpy(np.array(getattr(s, f.name)))
        for f in dataclasses.fields(ProjectedSplats)})
    return s, splats


def _pair_keys(splats, bins, num_tiles, cfg):
    """(tile, depth key) of every sorted pair of the port's bins, the key
    the sort ordered them by."""
    tile = torch.repeat_interleave(torch.arange(num_tiles),
                                   bins.tile_count.long())
    key = float_to_sortable_uint(splats.depth[bins.sorted_gidx.long()])
    return tile, key >> (32 - (sort_key_bits(num_tiles, cfg) or 32))


def _tie_free(splats, bins, num_tiles, cfg):
    tile, key = _pair_keys(splats, bins, num_tiles, cfg)
    same = (tile[1:] == tile[:-1]) & (key[1:] == key[:-1])
    return not bool(same.any())


# --- roundings --------------------------------------------------------------


def test_quantizers_match_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(scale=40.0, size=2000),
        # halfway cases of both roundings, the mean16 range's edges
        np.arange(-40, 40) / 64.0, [-1024.0, -1024.02, 1023.97, 1023.99,
                                    1500.0, -3000.0, 0.0, -0.0],
        (1.0 + (2 * np.arange(20) + 1) / 256.0) * 3.0,
    ]).astype(np.float32)
    for port_fn, jax_fn in ((quantize_bf16, jax_quantize_bf16),
                            (quantize_mean16, jax_quantize_mean16)):
        got = port_fn(torch.from_numpy(x)).numpy()
        want = np.asarray(jax_fn(jnp.asarray(x)))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        t = torch.from_numpy(x).requires_grad_(True)
        (g,) = torch.autograd.grad((port_fn(t) * 3.0).sum(), t)
        assert torch.equal(g, torch.full_like(t, 3.0))     # straight through
    assert not np.array_equal(quantize_mean16(torch.from_numpy(x)).numpy(),
                              x)


# --- binning ----------------------------------------------------------------

BIN_MODES = {
    "depth19": ("plain", dict(depth_bits=19)),
    "tier2": ("plain", dict(tier_split=2, tier_mid=0)),
    "tier2_mid4_overflow": ("overflow", dict(tier_split=2, tier_mid=4,
                                             mid_frac=0.01, big_frac=0.01)),
    "tile_cull": ("plain", dict(tile_cull=True)),
    "tile_cull_tiers": ("overflow", dict(tile_cull=True, tier_split=2,
                                         mid_frac=0.01, big_frac=0.01)),
    "jax_defaults": ("overflow", PACKED),
}


@pytest.mark.parametrize("mode", sorted(BIN_MODES))
def test_bins_match_jax(mode):
    kind, kw = BIN_MODES[mode]
    cloud, w, h = _scene(kind)
    cfg = BASE.replace(**kw)
    s, splats = _project(cloud, w, h, cfg)
    ref = _jax_bin(s, w, h, _jcfg(cfg))
    got = bin_splats(splats, w, h, cfg)
    num_tiles = cfg.num_tiles(w, h)

    start, count = np.asarray(ref.tile_start), np.asarray(ref.tile_count)
    np.testing.assert_array_equal(got.tile_start.numpy(), start)
    np.testing.assert_array_equal(got.tile_count.numpy(), count)
    assert int(got.num_pairs) == int(ref.num_pairs)
    assert int(got.overflow) == int(ref.overflow)
    if kind == "overflow":        # both compacted tiers dropped splats
        assert min(int(c) for c in got.comp_count) > 256
        assert got.comp_widths == tuple(ref.comp_widths)
    assert got.tier_a_width == ref.tier_a_width
    for mine, theirs in zip(got.comp_idx, ref.comp_idx):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))

    ref_gidx, gidx = np.asarray(ref.sorted_gidx), got.sorted_gidx.numpy()
    for t in np.nonzero(count)[0]:
        sl = slice(start[t], start[t] + count[t])
        assert sorted(gidx[sl]) == sorted(ref_gidx[sl]), f"tile {t}"
    # the slot permutation, and its live prefix where no keys tie
    slots = got.sorted_slot.numpy()
    np.testing.assert_array_equal(np.sort(slots),
                                  np.arange(ref.sorted_slot.shape[0]))
    assert _tie_free(splats, got, num_tiles, cfg)
    live = int(ref.num_pairs)
    np.testing.assert_array_equal(slots[:live],
                                  np.asarray(ref.sorted_slot)[:live])
    np.testing.assert_array_equal(gidx, ref_gidx[:gidx.shape[0]])


@pytest.mark.parametrize("kw", [dict(depth_bits=19), dict(PACKED)],
                         ids=["depth19", "jax_defaults"])
def test_bins_with_tied_keys_match_jax_as_sets(kw):
    """Where keys tie, the JAX package's unstable sort orders the tied
    pairs as it likes: the tiles' pair sets and counts agree, and each
    segment is non-decreasing in the key (tests/test_ops.py's check)."""
    cloud, w, h = _scene("ties")
    cfg = BASE.replace(**kw)
    s, splats = _project(cloud, w, h, cfg)
    ref = _jax_bin(s, w, h, _jcfg(cfg))
    got = bin_splats(splats, w, h, cfg)
    num_tiles = cfg.num_tiles(w, h)
    assert not _tie_free(splats, got, num_tiles, cfg)     # ties are there
    start, count = np.asarray(ref.tile_start), np.asarray(ref.tile_count)
    np.testing.assert_array_equal(got.tile_start.numpy(), start)
    np.testing.assert_array_equal(got.tile_count.numpy(), count)
    assert int(got.num_pairs) == int(ref.num_pairs)
    assert int(got.overflow) == int(ref.overflow)
    ref_gidx, gidx = np.asarray(ref.sorted_gidx), got.sorted_gidx.numpy()
    tile, key = _pair_keys(splats, got, num_tiles, cfg)
    assert bool(((tile[1:] > tile[:-1]) | (key[1:] >= key[:-1])).all())
    for t in np.nonzero(count)[0]:
        sl = slice(start[t], start[t] + count[t])
        assert sorted(gidx[sl]) == sorted(ref_gidx[sl]), f"tile {t}"


# --- render, image and gradients ---------------------------------------------


@pytest.mark.parametrize("sh_degree", [0, 3])
@pytest.mark.parametrize("mean16", [False, True], ids=["fields", "mean16"])
def test_render_image_and_param_grads_match_jax(mean16, sh_degree):
    """`render` under pack_fields (and pack_mean16) with the packed key and
    tiers, against the JAX package's XLA `render_impl` and `jax.grad`
    through it (the XLA compositor ignores pack_grads, so it is off)."""
    w, h = 40, 32
    cfg = BASE.replace(**{**PACKED, "pack_mean16": mean16,
                          "pack_grads": False})
    jcfg = _jcfg(cfg)
    src = make_random_cloud(20, seed=11, sh_degree=sh_degree)
    xyz = np.asarray(src.xyz).copy()
    xyz[1] = [0.0, 0.0, -50.0]               # far behind the camera
    src.xyz = xyz
    jmodel, _ = jax_pad_to_capacity(JaxModel.from_cloud(src), 26)
    kw = dict(eye=(0.2, -0.1, -6.0), center=(0.0, 0.0, 0.0))
    wgt = np.linspace(0.0, 1.0, w * h * 3, dtype=np.float32).reshape(h, w, 3)

    def jax_loss(m):
        img, _ = jax_render(m.to_cloud(), jax_camera.default_camera(
            w, h, **kw), w, h, jcfg)
        return jnp.sum(img * wgt), img

    (_, jimg), jg = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jmodel)

    model, _ = pad_to_capacity(
        GaussianModel.from_numpy(numpy_cloud_model(src)), 26)
    camera = port_camera.default_camera(w, h, **kw)
    img, _ = render(model.to_cloud(), camera, w, h, cfg)
    assert_images_close(img.detach().numpy(), np.asarray(jimg))
    (img * torch.from_numpy(wgt)).sum().backward()

    # no tied keys: the order is the JAX package's
    from gaussian_splatting_web_tpu_torch.ops.projection import (
        project_gaussians,
    )
    with torch.no_grad():
        splats = project_gaussians(model.to_cloud(), camera, w, h, cfg)
    assert _tie_free(splats, bin_splats(splats, w, h, cfg),
                     cfg.num_tiles(w, h), cfg)

    names = ("xyz", "log_scale", "quat", "opacity_logit", "sh_dc", "sh_rest")
    got = [getattr(model, f).grad for f in names]
    want = [np.asarray(getattr(jg, f)) for f in names]
    for g in got:
        assert torch.isfinite(g).all()
    stats = grad_parity([g for g, v in zip(got, want) if v.size],
                        [v for v in want if v.size])
    assert grad_parity_ok(stats, extra=2), stats


# --- the fold -----------------------------------------------------------------


@pytest.mark.parametrize("kind,kw", [
    ("overflow", dict(tier_split=2, mid_frac=0.01, big_frac=0.01,
                      pack_grads=False)),
    ("overflow", dict(tier_split=2, mid_frac=0.01, big_frac=0.01,
                      pack_grads=True)),
    ("plain", dict(pack_grads=True)),
], ids=["tiers", "tiers_pack_grads", "single_pack_grads"])
def test_fold_matches_jax(kind, kw):
    cloud, w, h = _scene(kind)
    cfg = BASE.replace(**kw)
    s, splats = _project(cloud, w, h, cfg)
    ref = _jax_bin(s, w, h, _jcfg(cfg))
    bins = bin_splats(splats, w, h, cfg)
    n = splats.depth.shape[0]
    m = bins.sorted_gidx.shape[0]
    assert m == int(ref.num_pairs)
    rows = np.random.default_rng(1).normal(size=(m, 9)).astype(np.float32)
    dp_jax = np.zeros((16, ref.pair_cap), np.float32)
    dp_jax[:9, :m] = rows.T
    want = np.asarray(_jax_fold(jnp.asarray(dp_jax), ref, n, _jcfg(cfg)))
    got = fold_pair_grads(torch.from_numpy(rows), bins, n, cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    plain = fold_pair_grads(torch.from_numpy(rows), bins, n).numpy()
    assert np.array_equal(got, plain) != cfg.pack_grads   # rounding acts
    if kind == "overflow":      # dropped splats get nothing
        dropped = np.setdiff1d(np.arange(n), np.concatenate(
            [np.unique(bins.sorted_gidx.numpy())]))
        assert dropped.size and not np.abs(got[dropped]).any()


# --- the packed anchor binning --------------------------------------------------

ACFG = BASE.replace(binning="anchor", pack_fields=True, pack_mean16=True,
                    pack_grads=False, gather_cap_factor=0.0)


def _anchor_scene(kind):
    if kind == "big":
        cloud = numpy_cloud(make_random_cloud(60, seed=3, sh_degree=0))
        cloud.log_scale = np.full((60, 3), -0.9, np.float32)
        return cloud
    n, seed = {"random300": (300, 0), "random120": (120, 7)}[kind]
    return numpy_cloud(make_random_cloud(n, seed=seed, sh_degree=0))


def _d16_strictly_ordered(abins, cfg, w, h):
    """Each tile's merged list rises strictly in d16, so ranking by (d16,
    lane) orders it as the f32 depths do."""
    merge = anchor.merge_tiles(abins, *cfg.grid_size(w, h), cfg)
    for t in range(merge.k_used.shape[0]):
        pos = merge.ordered[t, :int(merge.k_used[t])].long()
        d = abins.sorted_depth[pos]
        if not bool((d[1:] > d[:-1]).all()):
            return False
    return True


@pytest.mark.parametrize("kind", ["random300", "big"])
def test_packed_anchor_bins_match_jax(kind):
    w, h = 64, 48
    s, splats = _project(_anchor_scene(kind), w, h, ACFG)
    ref = _jax_bin_anchor(s, w, h, _jcfg(ACFG))
    got = anchor.bin_splats_anchor(splats, w, h, ACFG)
    starts = np.asarray(ref.starts)
    np.testing.assert_array_equal(got.starts.numpy(), starts)
    assert int(got.num_pairs) == int(ref.bins.num_pairs)
    assert int(got.overflow) == int(ref.bins.overflow)
    live = int(starts[-1])
    key = np.asarray(ref.slab[0][0])[:live]
    np.testing.assert_array_equal(got.sorted_depth.numpy()[:live],
                                  key & 0xFFFF)
    slots, ref_slots = got.sorted_slot.numpy(), np.asarray(
        ref.bins.sorted_slot)
    for t in range(len(starts) - 1):
        sl = slice(starts[t], starts[t + 1])
        assert sorted(slots[sl]) == sorted(ref_slots[sl]), f"tile {t}"
    # "big" has no two entries tied in (tile, d16), so the order is JAX's;
    # "random300" has ties, whose order JAX's unstable sort leaves open
    tie_free = bool(np.all(np.diff(key.astype(np.int64)) > 0))
    assert tie_free == (kind == "big")
    if tie_free:
        np.testing.assert_array_equal(slots[:live], ref_slots[:live])
        meta = np.asarray(ref.slab[0][6])[:live] & 0xFFFF
        np.testing.assert_array_equal(got.sorted_meta.numpy()[:live], meta)


def test_packed_anchor_forward_matches_pallas_interpret():
    """Kernel C's plain version on packed anchor bins against the Pallas
    kernel C (interpret mode) in its packed mode: bf16 fields, d16 order,
    the f32 mean (pack_mean16 is ignored by the anchor path in both)."""
    w, h = 64, 48
    s, splats = _project(_anchor_scene("random300"), w, h, ACFG)
    rgb, alpha, stats = rasterize_anchor(s, w, h, _jcfg(ACFG), True)
    abins = anchor.bin_splats_anchor(splats, w, h, ACFG)
    comp = anchor_cuda.composite_image_anchor(
        pack_splat_fields(splats, ACFG), abins, w, h, ACFG)
    img = torch.cat([comp.rgb, comp.alpha[..., None]], -1).numpy()
    assert_images_close(img, np.concatenate(
        [np.asarray(rgb), np.asarray(alpha)[..., None]], -1))
    assert int(abins.num_pairs) == int(stats["num_pairs"])
    # bf16 fields really changed the image against the exact mode's
    exact = anchor_cuda.composite_image_anchor(
        pack_splat_fields(splats), anchor.bin_splats_anchor(
            splats, w, h, ACFG.replace(pack_fields=False)), w, h,
        ACFG.replace(pack_fields=False))
    assert not torch.equal(exact.rgb, comp.rgb)


def test_packed_anchor_grads_match_jax_xla():
    """Packed anchor gradients against `jax.grad` of the XLA dup path in
    the same rounding (bf16 fields, f32 mean, exact single-tier bins:
    tests/test_anchor.py's `_oracle`) on a scene whose every tile's list
    rises strictly in d16."""
    w, h = 64, 48
    s, splats = _project(_anchor_scene("random120"), w, h, ACFG)
    abins = anchor.bin_splats_anchor(splats, w, h, ACFG)
    assert _d16_strictly_ordered(abins, ACFG, w, h)
    ref = _jcfg(ACFG.replace(binning="dup", pack_mean16=False))
    b = _jax_bin(s, w, h, ref)
    rng = np.random.default_rng(3)
    d_rgb = rng.normal(size=(h, w, 3)).astype(np.float32)
    d_alpha = rng.normal(size=(h, w)).astype(np.float32)
    rest = {f: getattr(s, f) for f in ("depth", "radius", "valid")}

    def f(mean2d, conic, rgb, opacity):
        return jax_rasterize_tiles(type(s)(mean2d=mean2d, conic=conic,
                                           rgb=rgb, opacity=opacity, **rest),
                                   b, w, h, ref)

    @jax.jit
    def run(primals, cot):
        out, vjp = jax.vjp(f, *primals)
        return out, vjp(cot)

    (jrgb, ja), grads = run((s.mean2d, s.conic, s.rgb, s.opacity),
                            (jnp.asarray(d_rgb), jnp.asarray(d_alpha)))
    want = np.concatenate([np.asarray(g).reshape(len(s.depth), -1)
                           for g in grads], axis=1)

    leaves = [splats.mean2d, splats.conic, splats.rgb, splats.opacity]
    for t in leaves:
        t.requires_grad_(True)
    comp = anchor_cuda.composite_image_anchor(
        pack_splat_fields(splats, ACFG), abins, w, h, ACFG)
    loss = ((comp.rgb * torch.from_numpy(d_rgb)).sum()
            + (comp.alpha * torch.from_numpy(d_alpha)).sum())
    got = torch.cat([g.reshape(len(splats.depth), -1) for g in
                     torch.autograd.grad(loss, leaves)], 1).numpy()
    img = torch.cat([comp.rgb, comp.alpha[..., None]], -1).detach().numpy()
    np.testing.assert_allclose(img, np.concatenate(
        [np.asarray(jrgb), np.asarray(ja)[..., None]], -1), atol=2e-4)
    assert np.abs(want).max() > 0
    for name, sl in SPLAT_FIELDS:
        scale = np.abs(want[:, sl]).max() + 1e-12
        np.testing.assert_allclose(got[:, sl], want[:, sl],
                                   atol=5e-4 + 1e-3 * scale, err_msg=name)


def test_packed_anchor_fold_rounds_like_jax():
    """`fold_anchor_grads` with pack_grads rounds the summed rows to bf16
    as JAX's anchor backward does before `_fold_pair_grads`."""
    w, h = 64, 48
    cfg = ACFG.replace(pack_grads=True)
    s, splats = _project(_anchor_scene("big"), w, h, cfg)
    ref = _jax_bin_anchor(s, w, h, _jcfg(cfg))
    abins = anchor.bin_splats_anchor(splats, w, h, cfg)
    m = abins.sorted_gidx.shape[0]
    live = int(abins.starts[-1])
    rows = np.zeros((4, m, 9), np.float32)
    rows[:, :live] = np.random.default_rng(2).normal(size=(4, live, 9))
    n = splats.depth.shape[0]
    got = anchor.fold_anchor_grads(torch.from_numpy(rows), abins, n,
                                   cfg).numpy()
    dsum = rows.sum(0)
    dp = np.zeros((16, ref.bins.pair_cap), np.float32)
    dp[:9, :m] = dsum.T
    want = np.asarray(_jax_fold(jnp.asarray(dp), ref.bins, n, _jcfg(cfg)))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


# --- the CLI ---------------------------------------------------------------------


def test_cli_depth_bits(monkeypatch):
    """`--depth-bits` sets the packed key's depth bits over the port's
    defaults, as the JAX CLI's flag of the same name does over its own."""
    import argparse

    from gaussian_splatting_web_tpu.cli import _config as jax_cli_config
    from gaussian_splatting_web_tpu_torch import cli

    seen = {}
    monkeypatch.setattr(cli, "cmd_render",
                        lambda a: seen.setdefault("cfg", cli._config(a)))
    cli.main(["render", "--ply", "x.ply", "--depth-bits", "19"])
    assert seen["cfg"] == RenderConfig(depth_bits=19)
    ns = argparse.Namespace(depth_bits=19)
    assert jax_cli_config(ns) == JaxConfig(depth_bits=19)
    assert JaxConfig(**dataclasses.asdict(seen["cfg"])).depth_bits == 19
