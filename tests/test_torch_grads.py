"""Gradients of the port vs the JAX package on the CPU:

  (a) the plain twin of backward kernel B + the fold against `jax.grad`
      through the XLA compositor `rasterize_tiles` (exact on the CPU) and
      through the Pallas kernels in interpret mode, as tests/test_pallas.py
      runs them;
  (b) the same twin against torch autograd through the plain forward;
  (c) `render`'s gradients with respect to every cloud parameter against
      `jax.grad(render_impl)`, at SH degrees 0 and 3, with behind-camera
      and zero-quaternion arena rows.

Tolerance: the scale-relative rule of the JAX package's
`bench_lib._grad_parity` (`bench_lib.grad_parity_ok`): p99 ≤ 1e-3, and at
most 1e-5 of the elements plus 2 knife-edge pairs off by more than 1% of
their leaf's largest value — f32 sums run in other orders, and a pair within
an ulp of the 1/255 cutoff, the 0.99 clamp or the early exit flips its
whole local contribution in one path only."""

import dataclasses
import types

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
from gaussian_splatting_web_tpu.ops.pallas.raster import (
    rasterize_tiles_pallas,
)
from gaussian_splatting_web_tpu.ops.rasterize import (
    rasterize_tiles as jax_rasterize_tiles,
)
from gaussian_splatting_web_tpu.ops.rasterize import render_impl as jax_render
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
from gaussian_splatting_web_tpu_torch.ops.cuda import build
from gaussian_splatting_web_tpu_torch.ops.cuda import raster as raster_cuda
from gaussian_splatting_web_tpu_torch.ops.rasterize import (
    composite_backward_plain,
    composite_image_plain,
    fold_pair_grads,
    pack_splat_fields,
    render,
)
from gaussian_splatting_web_tpu_torch.train.densify import pad_to_capacity
from tests.conftest import make_random_cloud
from tests.test_torch_raster import _bins, _opaque_scene, _random_scene

torch.set_num_threads(2)

CFG = RenderConfig(max_dup=16, max_per_tile=256)
JCFG = JaxConfig(**dataclasses.asdict(CFG))
SPLAT_FIELDS = (("mean2d", slice(0, 2)), ("conic", slice(2, 5)),
                ("rgb", slice(5, 8)), ("opacity", slice(8, 9)))
SCENES = {
    "random": (lambda: _random_scene(0), 64, 48),
    "opaque": (_opaque_scene, 48, 48),
    "ragged": (lambda: _random_scene(3, n=150, sh_degree=2, spread=2.5),
               72, 40),
}


def _cotangents(w, h, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(h, w, 3)).astype(np.float32),
            rng.normal(size=(h, w)).astype(np.float32))


def _twin_grads(splats, bins, w, h, d_rgb, d_alpha):
    """fold(composite_backward_plain) → [N, 9] for the given cotangents."""
    fields = pack_splat_fields(splats)
    comp = composite_image_plain(fields, bins, w, h, CFG)
    dpairs = composite_backward_plain(fields, bins, w, h, CFG, comp,
                                      torch.from_numpy(d_rgb),
                                      torch.from_numpy(d_alpha))
    assert dpairs.shape == (bins.sorted_gidx.shape[0], 9)
    return fold_pair_grads(dpairs, bins, fields.shape[0])


def _jax_splat_grads(raster_fn, s, d_rgb, d_alpha):
    def loss(sp):
        rgb, a = raster_fn(sp)
        return jnp.sum(rgb * d_rgb) + jnp.sum(a * d_alpha)

    g = jax.jit(jax.grad(loss, allow_int=True))(s)
    return np.concatenate(
        [np.asarray(getattr(g, name)).reshape(len(s.depth), -1)
         for name, _ in SPLAT_FIELDS], axis=1)


def _assert_parity(got, want):
    got = torch.as_tensor(got)
    want = torch.as_tensor(np.asarray(want))
    stats = grad_parity([got[:, sl] for _, sl in SPLAT_FIELDS],
                        [want[:, sl] for _, sl in SPLAT_FIELDS])
    assert grad_parity_ok(stats, extra=2), stats
    return stats


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_backward_twin_matches_jax_xla_and_pallas(scene):
    make, w, h = SCENES[scene]
    s, b, jcfg, splats, bins = _bins(make(), w, h, CFG)
    d_rgb, d_alpha = _cotangents(w, h)
    got = _twin_grads(splats, bins, w, h, d_rgb, d_alpha).numpy()
    assert np.abs(got).max() > 0

    want = _jax_splat_grads(
        lambda sp: jax_rasterize_tiles(sp, b, w, h, jcfg), s, d_rgb, d_alpha)
    _assert_parity(got, want)

    # the Pallas kernels B + fold in interpret mode: atol 5e-4 as in
    # tests/test_pallas.py for the bf16x2 cumsum's ~1e-4 weight noise, which
    # is relative, so scaled by each column's magnitude where it exceeds 1
    # (the opaque stack's geometry gradients reach ~40)
    pallas = _jax_splat_grads(
        lambda sp: rasterize_tiles_pallas(sp, b, w, h, jcfg, True), s,
        d_rgb, d_alpha)
    scale = np.maximum(np.abs(pallas).max(axis=0), 1.0)
    np.testing.assert_allclose(got / scale, pallas / scale, atol=5e-4)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_backward_twin_matches_autograd_of_plain_forward(scene):
    make, w, h = SCENES[scene]
    _, _, _, splats, bins = _bins(make(), w, h, CFG)
    d_rgb, d_alpha = _cotangents(w, h, seed=1)
    got = _twin_grads(splats, bins, w, h, d_rgb, d_alpha)

    fields = pack_splat_fields(splats).requires_grad_(True)
    comp = composite_image_plain(fields, bins, w, h, CFG)
    loss = ((comp.rgb * torch.from_numpy(d_rgb)).sum()
            + (comp.alpha * torch.from_numpy(d_alpha)).sum())
    (want,) = torch.autograd.grad(loss, fields)
    assert want[:, 9:].abs().max() == 0
    _assert_parity(got, want[:, :9])

    # the differentiable compositor on a CPU tensor: the twins, no kernel
    build.reset_launches()
    out = raster_cuda.composite_image(fields, bins, w, h, CFG)
    loss = ((out.rgb * torch.from_numpy(d_rgb)).sum()
            + (out.alpha * torch.from_numpy(d_alpha)).sum())
    (via_fn,) = torch.autograd.grad(loss, fields)
    counts = build.launch_counts()
    assert counts["A"] == counts["B"] == 0
    torch.testing.assert_close(via_fn[:, :9], got, rtol=0, atol=0)
    assert via_fn[:, 9:].abs().max() == 0


def _render_loss_weights(w, h):
    return np.linspace(0.0, 1.0, w * h * 3, dtype=np.float32).reshape(h, w, 3)


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_render_param_grads_match_jax(sh_degree):
    """Every cloud parameter, through projection, SH, binning and the
    compositor, with a behind-camera splat and zero-quaternion dead arena
    rows (tests/test_grads.py:91-164)."""
    w, h = 40, 32
    src = make_random_cloud(20, seed=11, sh_degree=sh_degree)
    xyz = np.asarray(src.xyz).copy()
    xyz[1] = [0.0, 0.0, -50.0]               # far behind the camera
    src.xyz = xyz
    jmodel, _ = jax_pad_to_capacity(JaxModel.from_cloud(src), 26)
    kw = dict(eye=(0.2, -0.1, -6.0), center=(0.0, 0.0, 0.0))
    wgt = _render_loss_weights(w, h)

    def jax_loss(m):
        img, _ = jax_render(m.to_cloud(), jax_camera.default_camera(
            w, h, **kw), w, h, JCFG)
        return jnp.sum(img * wgt)

    jg = jax.jit(jax.grad(jax_loss))(jmodel)

    model, _ = pad_to_capacity(
        GaussianModel.from_numpy(numpy_cloud_model(src)), 26)
    img, aux = render(model.to_cloud(), port_camera.default_camera(w, h, **kw),
                      w, h, CFG)
    assert int(aux["num_visible"]) < 20      # the culled rows are in play
    (img * torch.from_numpy(wgt)).sum().backward()

    names = ("xyz", "log_scale", "quat", "opacity_logit", "sh_dc", "sh_rest")
    got = [getattr(model, f).grad for f in names]
    want = [np.asarray(getattr(jg, f)) for f in names]
    for g in got:
        assert torch.isfinite(g).all()
    assert got[0][20:].abs().max() == 0       # dead rows: no gradient
    assert got[0][1].abs().max() == 0         # behind the camera
    stats = grad_parity([g for g, v in zip(got, want) if v.size],
                        [v for v in want if v.size])
    assert grad_parity_ok(stats, extra=2), stats


def numpy_cloud_model(cloud):
    """A JAX-package cloud as the six model arrays."""
    c = numpy_cloud(cloud)
    return types.SimpleNamespace(xyz=c.xyz, log_scale=c.log_scale,
                                 quat=c.quat, opacity_logit=c.opacity_logit,
                                 sh_dc=c.sh[:, :1], sh_rest=c.sh[:, 1:])
