"""The port's anchor-binning path (`ops/anchor.py`, the plain versions of
kernels C and D behind `ops/cuda/anchor.py`) vs the JAX package on the
CPU, fed the same projected splats:

  * `bin_splats_anchor` against the JAX package's exact mode: segment
    starts, every live entry's slot (its gaussian and its kind) in the same
    order, meta flags, the compacted big splats and the counts;
  * images against the XLA compositor oracle (dup binning, single tier) on
    scenes whose ranges fit their cover, atol 2e-4 as tests/test_anchor.py;
  * a crowded scene whose ranges overrun their aligned cover and whose
    tiles have more than k_cap candidates, where only the Pallas kernels C
    and D (interpret mode) are a reference: image and gradients;
  * gradients against `jax.grad` through the XLA oracle, and the plain
    backward against autograd through the plain forward;
  * `render` with binning='anchor' against the JAX `render_impl`, and one
    `train()` step.

Gradient tolerance: 5e-4 + 1e-3 · max|reference| per field, the rule of
tests/test_anchor.py for the Pallas kernels against the XLA oracle."""

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
from gaussian_splatting_web_tpu.ops.projection import (
    project_gaussians as jax_project,
)
from gaussian_splatting_web_tpu.ops.rasterize import (
    rasterize_tiles as jax_rasterize_tiles,
)
from gaussian_splatting_web_tpu.ops.rasterize import render_impl as jax_render
from gaussian_splatting_web_tpu.ops.sort import bin_splats as jax_bin
from gaussian_splatting_web_tpu_torch.bench_lib import (
    grad_parity,
    grad_parity_ok,
)
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core import camera as port_camera
from gaussian_splatting_web_tpu_torch.ops import anchor
from gaussian_splatting_web_tpu_torch.ops.cuda import anchor as anchor_cuda
from gaussian_splatting_web_tpu_torch.ops.cuda import build
from gaussian_splatting_web_tpu_torch.ops.projection import ProjectedSplats
from gaussian_splatting_web_tpu_torch.ops.rasterize import (
    pack_splat_fields,
    render,
)
from tests.conftest import make_random_cloud
from tests.test_torch_grads import numpy_cloud_model

torch.set_num_threads(2)

W, H = 64, 48
CFG = RenderConfig(max_dup=16, max_per_tile=256, binning="anchor")
JCFG = JaxConfig(**dataclasses.asdict(CFG))
SPLAT_FIELDS = (("mean2d", slice(0, 2)), ("conic", slice(2, 5)),
                ("rgb", slice(5, 8)), ("opacity", slice(8, 9)))


def _cloud(kind):
    """The scenes of tests/test_anchor.py, as numpy clouds."""
    if kind.startswith("random"):
        n, seed = {"random300": (300, 0), "random800": (800, 1),
                   "random40": (40, 5)}[kind]
        return numpy_cloud(make_random_cloud(n, seed=seed, sh_degree=0))
    if kind == "big":        # mostly large footprints: the dup tier
        cloud = numpy_cloud(make_random_cloud(60, seed=3, sh_degree=0))
        cloud.log_scale = np.full((60, 3), -0.9, np.float32)
        return cloud
    if kind == "culled":     # everything behind the camera
        cloud = numpy_cloud(make_random_cloud(32, seed=0, sh_degree=0))
        cloud.xyz = cloud.xyz + np.array([0, 0, -100.0], np.float32)
        return cloud
    if kind == "opaque":     # stacked opaque splats: early exit
        n = 40
        cloud = numpy_cloud(make_random_cloud(n, seed=5, sh_degree=0))
        rng = np.random.default_rng(7)
        cloud.xyz = np.concatenate(
            [rng.normal(scale=0.05, size=(n, 2)), rng.uniform(-2, 2, (n, 1))],
            axis=1).astype(np.float32)
        cloud.opacity_logit = np.full((n,), 6.0, np.float32)
        cloud.log_scale = np.full((n, 3), -0.7, np.float32)
        return cloud
    assert kind == "crowded"  # 2500 small splats over the central tiles
    return numpy_cloud(make_random_cloud(2500, seed=9, sh_degree=0,
                                         spread=0.3))


def _project(cloud, cfg=CFG):
    """The JAX projection, and the same splats as port tensors."""
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    camera = jax_camera.default_camera(W, H, eye=(0, 0, -6), center=(0, 0, 0))
    s = jax_project(cloud, camera, W, H, jcfg)
    splats = ProjectedSplats(**{
        f.name: torch.from_numpy(np.array(getattr(s, f.name)))
        for f in dataclasses.fields(ProjectedSplats)})
    return s, splats, jcfg


def _oracle(s, jcfg):
    """The XLA compositor over single-tier dup bins → [H, W, 4]."""
    ref = jcfg.replace(tier_split=0)

    @jax.jit
    def run(s):
        return jax_rasterize_tiles(s, jax_bin(s, W, H, ref), W, H, ref)

    rgb, a = run(s)
    return np.concatenate([np.asarray(rgb), np.asarray(a)[..., None]], -1)


def _image(comp):
    return torch.cat([comp.rgb, comp.alpha[..., None]], -1).detach().numpy()


@pytest.mark.parametrize("kind,max_dup", [("random300", 16), ("big", 16),
                                          ("big", 2), ("culled", 16)])
def test_bin_splats_anchor_matches_jax(kind, max_dup):
    cfg = CFG.replace(max_dup=max_dup)
    s, splats, jcfg = _project(_cloud(kind), cfg)
    ref = jax.jit(jax_bin_anchor, static_argnums=(1, 2, 3))(s, W, H, jcfg)
    got = anchor.bin_splats_anchor(splats, W, H, cfg)

    starts = np.asarray(ref.starts)
    np.testing.assert_array_equal(got.starts.numpy(), starts)
    live = int(starts[-1])
    # slot = gaussian id for an anchor, N + k·cap_b + j for a dup entry
    np.testing.assert_array_equal(got.sorted_slot.numpy()[:live],
                                  np.asarray(ref.bins.sorted_slot)[:live])
    np.testing.assert_array_equal(got.sorted_meta.numpy()[:live],
                                  np.asarray(ref.slab[1][2])[:live])
    np.testing.assert_array_equal(got.idx_b.numpy(),
                                  np.asarray(ref.bins.comp_idx[0]))
    assert int(got.num_pairs) == int(ref.bins.num_pairs)
    assert int(got.overflow) == int(ref.bins.overflow)
    n = splats.depth.shape[0]
    slots = got.sorted_slot.numpy()
    assert sorted(slots) == list(range(slots.shape[0]))
    cap_b = got.idx_b.shape[0]
    dup_ids = got.idx_b.numpy()[(slots[:live][slots[:live] >= n] - n) % cap_b]
    assert int(got.n_big) == len(set(dup_ids.tolist()))
    gid = got.sorted_gidx.numpy()[:live]
    np.testing.assert_array_equal(
        gid, np.where(slots[:live] < n, slots[:live],
                      got.idx_b.numpy()[(slots[:live] - n) % cap_b]))
    if kind == "big":
        assert int(got.n_big) > 10          # the dup tier is in play
        assert (int(got.overflow) > 0) == (max_dup == 2)
    if kind == "culled":
        assert live == 0 and int(got.num_pairs) == 0


@pytest.mark.parametrize("kind", ["random300", "random800", "random40",
                                  "big", "opaque"])
def test_anchor_image_matches_xla_oracle(kind):
    s, splats, jcfg = _project(_cloud(kind))
    abins = anchor.bin_splats_anchor(splats, W, H, CFG)
    rng = anchor.tile_ranges(abins, *CFG.grid_size(W, H), CFG)
    assert int((rng.s1 - rng.base).max()) <= anchor.c_max(CFG) * anchor.KCL
    build.reset_launches()
    comp = anchor_cuda.composite_image_anchor(pack_splat_fields(splats),
                                              abins, W, H, CFG)
    assert build.launch_counts()["C"] == 0
    np.testing.assert_allclose(_image(comp), _oracle(s, jcfg), atol=2e-4)
    if kind == "opaque":
        assert (comp.alpha > 0.999).any()
    assert "anchor_fwd" not in build._libs       # nothing was compiled


def _jax_grads(fn, s, d_rgb, d_alpha):
    """(image [H, W, 4], [N, 9] splat gradients) of fn(splats) → (rgb, a)
    for the cotangents."""
    rest = {f: getattr(s, f) for f in ("depth", "radius", "valid")}

    def f(mean2d, conic, rgb, opacity):
        return fn(type(s)(mean2d=mean2d, conic=conic, rgb=rgb,
                          opacity=opacity, **rest))

    @jax.jit
    def run(primals, cot):
        out, vjp = jax.vjp(f, *primals)
        return out, vjp(cot)

    (rgb, a), grads = run((s.mean2d, s.conic, s.rgb, s.opacity),
                          (jnp.asarray(d_rgb), jnp.asarray(d_alpha)))
    img = np.concatenate([np.asarray(rgb), np.asarray(a)[..., None]], -1)
    return img, np.concatenate(
        [np.asarray(g).reshape(len(s.depth), -1) for g in grads], axis=1)


def _port_grads(splats, abins, d_rgb, d_alpha):
    fields = pack_splat_fields(splats).requires_grad_(True)
    comp = anchor_cuda.composite_image_anchor(fields, abins, W, H, CFG)
    loss = ((comp.rgb * torch.from_numpy(d_rgb)).sum()
            + (comp.alpha * torch.from_numpy(d_alpha)).sum())
    (g,) = torch.autograd.grad(loss, fields)
    assert g[:, 9:].abs().max() == 0
    return comp, g[:, :9].numpy()


def _assert_grads_close(got, want):
    for name, sl in SPLAT_FIELDS:
        scale = np.abs(want[:, sl]).max() + 1e-12
        np.testing.assert_allclose(got[:, sl], want[:, sl],
                                   atol=5e-4 + 1e-3 * scale, err_msg=name)


def _cotangents(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(H, W, 3)).astype(np.float32),
            rng.normal(size=(H, W)).astype(np.float32))


def test_crowded_scene_truncation_matches_pallas_interpret():
    """Ranges longer than their aligned cover lose their tail, and tiles
    with more than k_cap touched candidates keep the k_cap nearest: only
    the Pallas kernels (interpret mode) do that, so they are the
    reference here, image and gradients from one vjp."""
    s, splats, jcfg = _project(_cloud("crowded"))
    abins = anchor.bin_splats_anchor(splats, W, H, CFG)
    gx, gy = CFG.grid_size(W, H)
    rng = anchor.tile_ranges(abins, gx, gy, CFG)
    assert int((rng.s1 - rng.base).max()) > anchor.c_max(CFG) * anchor.KCL
    merge = anchor.merge_tiles(abins, gx, gy, CFG)
    # touched candidates: the union without the k_cap cut
    wide = anchor.merge_tiles(abins, gx, gy, CFG.replace(max_per_tile=2560))
    assert int(wide.k_used.max()) > anchor.k_cap(CFG)
    assert int(merge.k_used.max()) == anchor.k_cap(CFG)

    d_rgb, d_alpha = _cotangents()
    img, want = _jax_grads(
        lambda sp: rasterize_anchor(sp, W, H, jcfg, True)[:2], s, d_rgb,
        d_alpha)
    comp, got = _port_grads(splats, abins, d_rgb, d_alpha)
    np.testing.assert_allclose(_image(comp), img, atol=2e-4)
    _assert_grads_close(got, want)


def test_anchor_grads_match_jax_xla_oracle():
    s, splats, jcfg = _project(make_random_cloud(500, seed=1, sh_degree=0))
    ref = jcfg.replace(tier_split=0)
    b = jax_bin(s, W, H, ref)
    d_rgb, d_alpha = _cotangents(1)
    img, want = _jax_grads(lambda sp: jax_rasterize_tiles(sp, b, W, H, ref),
                           s, d_rgb, d_alpha)
    abins = anchor.bin_splats_anchor(splats, W, H, CFG)
    comp, got = _port_grads(splats, abins, d_rgb, d_alpha)
    np.testing.assert_allclose(_image(comp), img, atol=2e-4)
    assert np.abs(want).max() > 0
    _assert_grads_close(got, want)


@pytest.mark.parametrize("kind", ["random300", "big", "opaque"])
def test_backward_plain_matches_autograd_of_plain_forward(kind):
    _, splats, _ = _project(_cloud(kind))
    abins = anchor.bin_splats_anchor(splats, W, H, CFG)
    d_rgb, d_alpha = (torch.from_numpy(a) for a in _cotangents(2))
    fields = pack_splat_fields(splats).requires_grad_(True)
    comp, _ = anchor.composite_anchor_plain(fields, abins, W, H, CFG)
    loss = (comp.rgb * d_rgb).sum() + (comp.alpha * d_alpha).sum()
    (want,) = torch.autograd.grad(loss, fields)

    dpairs = anchor.composite_anchor_backward_plain(
        fields.detach(), abins, W, H, CFG, comp, d_rgb, d_alpha)
    assert dpairs.shape == (4, abins.sorted_gidx.shape[0], 9)
    # rows only at live entries, at most one per (entry, group)
    live = int(abins.starts[-1])
    assert dpairs[:, live:].abs().max() == 0
    got = anchor.fold_anchor_grads(dpairs, abins, fields.shape[0])
    assert want[:, 9:].abs().max() == 0 and got.abs().max() > 0
    # f32 sums in another order (tests/test_torch_grads.py's rule)
    stats = grad_parity([got[:, sl] for _, sl in SPLAT_FIELDS],
                        [want[:, sl] for _, sl in SPLAT_FIELDS])
    assert grad_parity_ok(stats, extra=2), stats


def test_merge_edge_tiles_and_groups():
    """Row 0 has no range A and column 0 no left column; every kept entry
    is touched, ranked by depth, and grouped by range row × tx parity."""
    _, splats, _ = _project(_cloud("random800"))
    abins = anchor.bin_splats_anchor(splats, W, H, CFG)
    gx, gy = CFG.grid_size(W, H)
    merge = anchor.merge_tiles(abins, gx, gy, CFG)
    rng = anchor.tile_ranges(abins, gx, gy, CFG)
    assert (rng.s1[:gx, 0] == rng.s0[:gx, 0]).all()            # row 0: no A
    col0 = torch.arange(0, gx * gy, gx)
    assert (rng.s0[col0] == rng.sb[col0]).all()                # column 0
    for t in range(gx * gy):
        k = int(merge.k_used[t])
        pos = merge.ordered[t, :k].long()
        assert (merge.ordered[t, k:] == -1).all()
        depth = abins.sorted_depth[pos].long() & 0xFFFFFFFF
        assert (depth[1:] >= depth[:-1]).all()
        in_b = (pos >= rng.s0[t, 1]) & (pos < rng.s1[t, 1])
        want_group = in_b.long() * 2 + (t % gx) % 2
        assert torch.equal(merge.group[t, :k].long(), want_group)
        assert int(pos.unique().numel()) == k


def _port_scene(kind):
    """Port-only scenes (no JAX) for the binning's order invariant."""
    from gaussian_splatting_web_tpu_torch.bench_lib import (
        make_adversarial_scene,
        make_scene,
    )
    if kind == "adversarial":
        return make_adversarial_scene(device="cpu"), 96, 64
    cloud = make_scene(800, seed=1, sh_degree=0,
                       log_scale_range=(-3.5, -1.5), device="cpu")
    if kind == "crowded":
        cloud.xyz = cloud.xyz * 0.15
    elif kind == "ties":     # every splat on z = 0: one depth for all
        cloud.xyz[:, 2] = 0.0
    return cloud, W, H


@pytest.mark.parametrize("kind", ["random", "crowded", "adversarial",
                                  "ties"])
def test_anchor_segments_ascend_in_depth_then_position(kind):
    """The invariant kernel C's merge relies on: every anchor tile's
    segment of the sorted entries ascends in (sortable depth, position), so
    each of a tile's four runs (two ranges x two columns) is already sorted
    by the merge key (depth, union lane) and the kernel merges runs instead
    of sorting. Exact depth ties keep slot order (the stable sort)."""
    from gaussian_splatting_web_tpu_torch.core.camera import default_camera
    from gaussian_splatting_web_tpu_torch.ops.projection import (
        project_gaussians,
    )
    cloud, w, h = _port_scene(kind)
    camera = default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    abins = anchor.bin_splats_anchor(project_gaussians(cloud, camera, w, h,
                                                       CFG), w, h, CFG)
    live = int(abins.starts[-1])
    tile = torch.searchsorted(abins.starts.long(), torch.arange(live),
                              right=True) - 1
    depth = abins.sorted_depth[:live].long() & 0xFFFFFFFF
    same = tile[1:] == tile[:-1]
    assert bool((depth[1:] >= depth[:-1])[same].all())
    # exact ties keep slot order, as the stable sort promises
    tie = (depth[1:] == depth[:-1]) & same
    slot = abins.sorted_slot[:live]
    assert bool((slot[1:] > slot[:-1])[tie].all())
    assert (int(tie.sum()) > 100) if kind == "ties" else (live > 100)


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_render_anchor_matches_jax_render(sh_degree):
    """`render` with binning='anchor' (the plain C and D on the CPU)
    against the JAX render_impl, which on the CPU takes the XLA dup path:
    the image and every cloud parameter's gradient."""
    w, h = 40, 32
    src = make_random_cloud(40, seed=12, sh_degree=sh_degree)
    kw = dict(eye=(0.2, -0.1, -6.0), center=(0.0, 0.0, 0.0))
    wgt = np.linspace(0.0, 1.0, w * h * 3, dtype=np.float32).reshape(h, w, 3)
    jmodel = JaxModel.from_cloud(src)

    def jax_loss(m):
        img, _ = jax_render(m.to_cloud(), jax_camera.default_camera(
            w, h, **kw), w, h, JCFG)
        return jnp.sum(img * wgt), img

    (_, img0), jg = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jmodel)

    from gaussian_splatting_web_tpu_torch.models.gaussian_model import (
        GaussianModel,
    )
    model = GaussianModel.from_numpy(numpy_cloud_model(src))
    img, aux = render(model.to_cloud(), port_camera.default_camera(w, h, **kw),
                      w, h, CFG)
    (img * torch.from_numpy(wgt)).sum().backward()
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img0),
                               atol=2e-4)
    assert int(aux["overflow"]) == 0 and int(aux["num_pairs"]) > 0
    for f in ("xyz", "log_scale", "quat", "opacity_logit", "sh_dc",
              "sh_rest"):
        want = np.asarray(getattr(jg, f))
        if not want.size:
            continue
        got = getattr(model, f).grad.numpy()
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(got, want, atol=5e-4 + 1e-3 * scale,
                                   err_msg=f)


def test_train_step_with_anchor_binning():
    from gaussian_splatting_web_tpu_torch.io.dataset import View
    from gaussian_splatting_web_tpu_torch.models.gaussian_model import (
        GaussianModel,
    )
    from gaussian_splatting_web_tpu_torch.train.train_loop import (
        TrainLoopConfig,
        train,
    )

    w, h = 32, 32
    camera = port_camera.default_camera(w, h, eye=(0, 0, -6),
                                        center=(0, 0, 0))
    target = np.random.default_rng(0).uniform(size=(h, w, 3)).astype(
        np.float32)
    model = GaussianModel.from_numpy(numpy_cloud_model(
        make_random_cloud(60, seed=4, sh_degree=1)))
    before = model.xyz.detach().clone()
    build.reset_launches()
    state, _ = train(model, [View(camera=camera, image=target, name="v")],
                     w, h, render_config=CFG.replace(max_per_tile=256),
                     loop=TrainLoopConfig(iterations=2, densify_from=100),
                     device="cpu")
    counts = build.launch_counts()
    assert counts["C"] == counts["D"] == 0
    assert torch.isfinite(state.model.xyz).all()
    assert not torch.equal(state.model.xyz, before)
