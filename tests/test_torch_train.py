"""The port's training path vs the JAX package on the CPU: losses, the
per-group Adam, a densify round with the Adam row resets, one training
step's loss and gradients, end-to-end training (the recipes of
tests/test_train_loop.py and tests/test_train_quality.py), checkpoints,
the PNG decoder, the dataset loader and `cli train`.

Inputs are made from seeds with NumPy and handed to both packages; the
densify round gets JAX's own split noise."""

import dataclasses
import json
import math
import os
import re
import struct
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussian_splatting_web_tpu.config import RenderConfig as JaxConfig
from gaussian_splatting_web_tpu.core import camera as jax_camera
from gaussian_splatting_web_tpu.io.dataset import (
    load_dataset as jax_load_dataset,
)
from gaussian_splatting_web_tpu.io.dataset import (
    scene_extent as jax_scene_extent,
)
from gaussian_splatting_web_tpu.models.gaussian_model import (
    GaussianModel as JaxModel,
)
from gaussian_splatting_web_tpu.ops.rasterize import render_impl as jax_render
from gaussian_splatting_web_tpu.train import densify as jax_densify
from gaussian_splatting_web_tpu.train import loss as jax_loss
from gaussian_splatting_web_tpu.train.train_loop import (
    reset_opt_opacity as jax_reset_opt_opacity,
)
from gaussian_splatting_web_tpu.train.train_loop import (
    reset_opt_rows as jax_reset_opt_rows,
)
from gaussian_splatting_web_tpu.train.trainer import (
    make_optimizer as jax_make_optimizer,
)
from gaussian_splatting_web_tpu_torch.bench_lib import (
    grad_parity,
    grad_parity_ok,
)
from gaussian_splatting_web_tpu_torch.cli import main as cli_main
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core import camera as cam
from gaussian_splatting_web_tpu_torch.core.types import GaussianCloud
from gaussian_splatting_web_tpu_torch.io.dataset import (
    View,
    load_dataset,
    scene_extent,
)
from gaussian_splatting_web_tpu_torch.io.ply import read_ply, write_ply
from gaussian_splatting_web_tpu_torch.models.gaussian_model import (
    PARAMS,
    GaussianModel,
)
from gaussian_splatting_web_tpu_torch.ops.rasterize import render
from gaussian_splatting_web_tpu_torch.train import loss
from gaussian_splatting_web_tpu_torch.train.checkpoint import (
    has_checkpoint,
    load_ply_model,
    restore_loop_state,
    save_loop_state,
    save_ply,
)
from gaussian_splatting_web_tpu_torch.train.densify import (
    DensifyState,
    compact,
    densify_and_prune,
    pad_to_capacity,
    reset_opacity,
)
from gaussian_splatting_web_tpu_torch.train.train_loop import (
    TrainLoopConfig,
    reset_opt_opacity,
    reset_opt_rows,
    train,
)
from gaussian_splatting_web_tpu_torch.train.trainer import (
    TrainState,
    apply_gradients,
    make_optimizer,
)
from gaussian_splatting_web_tpu_torch.utils.image import (
    _png_bytes,
    read_png,
    write_png,
)
from tests.conftest import make_random_cloud

torch.set_num_threads(2)

# optax's f32 Adam bias correction vs torch's double one, over ≤ 6 steps of
# lr ≤ 0.05 (see test_optimizer_matches_optax)
ADAM_ATOL = 5e-6
# Adam moments: f32 sums in another order (XLA contracts to FMA), 1e-6 of
# the scale of the test gradients (1e-3) and of their squares
MOMENT_ATOL = {"mu": 1e-9, "nu": 1e-12}


def _port_cloud(jax_cloud) -> GaussianCloud:
    return GaussianCloud.from_numpy(types.SimpleNamespace(
        **{f: np.asarray(getattr(jax_cloud, f))
           for f in ("xyz", "log_scale", "quat", "opacity_logit", "sh")}))


def _jax_moments(opt_state) -> dict:
    """{("mu" | "nu", field): array} from optax multi_transform's state."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(opt_state):
        m = re.search(r"\.(mu|nu)\.(\w+)$", jax.tree_util.keystr(path))
        if m:
            out[(m.group(1), m.group(2))] = np.asarray(leaf)
    return out


def _port_moments(model, optimizer) -> dict:
    out = {}
    for f in PARAMS:
        st = optimizer.state[getattr(model, f)]
        out[("mu", f)] = st["exp_avg"].numpy()
        out[("nu", f)] = st["exp_avg_sq"].numpy()
    return out


def _shared_grads(model, seed):
    """Random gradients for every parameter, a few rows exactly zero."""
    rng = np.random.default_rng(seed)
    grads = {}
    for f in PARAMS:
        g = rng.normal(scale=1e-3, size=getattr(model, f).shape)
        g[:2] = 0.0
        grads[f] = g.astype(np.float32)
    return grads


def _adam_both(jmodel, model, state_j, opt_j, state_p, steps, seed):
    """`steps` updates of both optimizers on the same NumPy gradients."""
    @jax.jit
    def update(g, state_j, jmodel):
        upd, state_j = opt_j.update(g, state_j, jmodel)
        return optax.apply_updates(jmodel, upd), state_j

    for i in range(steps):
        g = _shared_grads(model, seed + i)
        jmodel, state_j = update(
            JaxModel(**{f: jnp.asarray(v) for f, v in g.items()}), state_j,
            jmodel)
        for f in PARAMS:
            getattr(model, f).grad = torch.from_numpy(g[f])
        apply_gradients(state_p)
    return jmodel, state_j


def _assert_params_close(model, jmodel, atol):
    for f in PARAMS:
        np.testing.assert_allclose(getattr(model, f).detach().numpy(),
                                   np.asarray(getattr(jmodel, f)),
                                   rtol=1e-6, atol=atol, err_msg=f)


def test_optimizer_matches_optax():
    """Per-group Adam with eps 1e-15 against optax multi_transform, fed
    the same gradients. position_lr_max_steps=4 puts the exponential decay
    and its clip at the end value inside the 6 steps. Tolerance: optax
    forms the bias correction 1 − 0.999ᵗ in f32, off by up to 1.3e-5
    relative at t = 1 (torch forms it in double), so an update (≈ ±lr, at
    most 0.05) differs by up to ~7e-7 per step: atol ADAM_ATOL."""
    cloud = make_random_cloud(12, seed=1, sh_degree=1)
    jmodel = JaxModel.from_cloud(cloud)
    kw = dict(scene_extent=2.5, position_lr_max_steps=4)
    opt_j = jax_make_optimizer(**kw)
    state_j = opt_j.init(jmodel)
    model = GaussianModel.from_numpy(jmodel)
    state_p = TrainState(model, make_optimizer(model, **kw))
    sched = optax.exponential_decay(1.6e-4 * 2.5, 4, 0.01,
                                    end_value=1.6e-6 * 2.5)
    for step in range(6):
        jmodel, state_j = _adam_both(jmodel, model, state_j, opt_j, state_p,
                                     1, seed=10 * step)
        assert math.isclose(state_p.optimizer.param_groups[0]["lr"],
                            float(sched(step)), rel_tol=1e-6)
        _assert_params_close(model, jmodel, atol=ADAM_ATOL)
    moments_j, moments_p = _jax_moments(state_j), _port_moments(
        model, state_p.optimizer)
    for k, v in moments_j.items():
        np.testing.assert_allclose(moments_p[k], v, rtol=1e-5, atol=MOMENT_ATOL[k[0]],
                                   err_msg=str(k))
    assert state_p.step == 6


@pytest.mark.parametrize("capacity", [40, 30])
def test_densify_round_matches_jax(capacity):
    """A round with clones, splits, opacity, world-size and screen-size
    prunes, after two Adam steps; capacity 30 leaves too few free slots, so
    allocation overflows and some splits degrade to clones. JAX's split
    noise is handed over. Then the Adam rows the round touched are zeroed
    (reset_opt_rows) and all opacity moments (reset_opt_opacity)."""
    n = 24
    rng = np.random.default_rng(capacity)
    cloud = make_random_cloud(n, seed=9, sh_degree=1)
    log_scale = np.asarray(cloud.log_scale).copy()
    log_scale[3] = 0.0                       # > 0.1 · extent: world prune
    cloud.log_scale = log_scale
    logit = np.asarray(cloud.opacity_logit).copy()
    logit[[5, 6]] = -6.0                     # opacity < 0.005: pruned
    cloud.opacity_logit = logit
    jmodel, _ = jax_densify.pad_to_capacity(JaxModel.from_cloud(cloud),
                                            capacity)
    alive = np.arange(capacity) < n
    stats = dict(
        grad_accum=(rng.uniform(0, 6e-4, capacity) * alive).astype(np.float32),
        denom=(rng.integers(1, 4, capacity) * alive).astype(np.float32),
        alive=alive,
        max_radius2d=(rng.uniform(0, 25, capacity) * alive).astype(np.float32))
    kw = dict(grad_threshold=2e-4, percent_dense=0.01, scene_extent=5.0,
              min_opacity=0.005, max_world_radius_frac=0.1,
              max_screen_size=20.0)

    opt_j = jax_make_optimizer(scene_extent=5.0)
    state_j = opt_j.init(jmodel)
    model = GaussianModel.from_numpy(jmodel)
    state_p = TrainState(model, make_optimizer(model, scene_extent=5.0))
    jmodel, state_j = _adam_both(jmodel, model, state_j, opt_j, state_p, 2,
                                 seed=3)

    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    noise = [np.asarray(jax.random.normal(k, (capacity, 3))) for k in (k1, k2)]
    jm, js, jchanged = jax.jit(
        lambda m, st, k: jax_densify.densify_and_prune(m, st, k, **kw))(
        jmodel, jax_densify.DensifyState(
            **{k: jnp.asarray(v) for k, v in stats.items()}), key)
    _, ps, changed = densify_and_prune(
        model, DensifyState(**{k: torch.from_numpy(v)
                               for k, v in stats.items()}),
        noise=noise, **kw)

    np.testing.assert_array_equal(ps.alive.numpy(), np.asarray(js.alive))
    np.testing.assert_array_equal(changed.numpy(), np.asarray(jchanged))
    assert ps.grad_accum.abs().max() == 0 and ps.max_radius2d.abs().max() == 0
    # the round did each kind of work
    assert changed[n:].any() and not ps.alive[[3, 5, 6]].any()
    if capacity == 30:
        assert int(ps.alive.sum()) <= capacity
    _assert_params_close(model, jm, atol=ADAM_ATOL)

    state_j = jax_reset_opt_rows(state_j, jchanged)
    reset_opt_rows(state_p.optimizer, changed)
    moments_p = _port_moments(model, state_p.optimizer)
    for k, v in _jax_moments(state_j).items():
        np.testing.assert_allclose(moments_p[k], v, rtol=1e-5, atol=MOMENT_ATOL[k[0]],
                                   err_msg=str(k))
        assert np.abs(moments_p[k][changed.numpy()]).max(initial=0) == 0

    state_j = jax_reset_opt_opacity(state_j, capacity)
    reset_opt_opacity(state_p.optimizer, model.opacity_logit)
    moments_p = _port_moments(model, state_p.optimizer)
    for k, v in _jax_moments(state_j).items():
        np.testing.assert_allclose(moments_p[k], v, rtol=1e-5, atol=MOMENT_ATOL[k[0]],
                                   err_msg=str(k))
    assert moments_p[("mu", "opacity_logit")].max() == 0


def test_reset_opacity_pad_and_compact_match_jax():
    cloud = make_random_cloud(10, seed=2, sh_degree=0)
    jmodel, js = jax_densify.pad_to_capacity(JaxModel.from_cloud(cloud), 16)
    model, ps = pad_to_capacity(GaussianModel.from_numpy(
        JaxModel.from_cloud(cloud)), 16)
    _assert_params_close(model, jmodel, atol=0)
    np.testing.assert_array_equal(ps.alive.numpy(), np.asarray(js.alive))
    alive = np.arange(16) < 8
    jm = jax_densify.reset_opacity(jmodel, jnp.asarray(alive))
    reset_opacity(model, torch.from_numpy(alive))
    _assert_params_close(model, jm, atol=0)
    jc = jax_densify.compact(jm, dataclasses.replace(js, alive=alive))
    pc = compact(model, dataclasses.replace(ps, alive=torch.from_numpy(alive)))
    assert pc.num_gaussians == 8
    _assert_params_close(pc, jc, atol=0)


def test_losses_match_jax():
    """L1, SSIM (11×11, σ 1.5, SAME padding), the photometric loss and its
    gradient against the JAX package. Tolerance: f32 convolutions summed
    in another order (rtol 1e-5)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(20, 24, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(
        np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(loss.ssim(ta, tb)),
                               float(jax_loss.ssim(a, b)), rtol=1e-5)
    np.testing.assert_allclose(float(loss.l1_loss(ta, tb)),
                               float(jax_loss.l1_loss(a, b)), rtol=1e-6)
    assert loss.psnr(ta, tb) == pytest.approx(jax_loss.psnr(a, b), rel=1e-6)
    ta.requires_grad_(True)
    val = loss.photometric_loss(ta, tb, 0.2)
    val.backward()
    jval, jgrad = jax.value_and_grad(jax_loss.photometric_loss)(a, b, 0.2)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-8)


def test_train_step_loss_and_grads_match_jax():
    """One step's photometric loss through `render` and its gradients with
    respect to every model parameter, against jax.grad of the JAX
    package's loss (the rule of tests/test_torch_grads.py)."""
    w, h = 40, 32
    cfg = RenderConfig(max_dup=16, max_per_tile=256)
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    kw = dict(eye=(0.4, 0.3, -5.0), center=(0.0, 0.0, 0.0))
    with torch.no_grad():
        target, _ = render(_port_cloud(make_random_cloud(24, seed=5)),
                           cam.default_camera(w, h, **kw), w, h, cfg)
    jmodel = JaxModel.from_cloud(make_random_cloud(24, seed=6, sh_degree=1))

    def jloss(m):
        img, _ = jax_render(m.to_cloud(0), jax_camera.default_camera(
            w, h, **kw), w, h, jcfg)
        return jax_loss.photometric_loss(img, target.numpy(), 0.2)

    jval, jg = jax.jit(jax.value_and_grad(jloss))(jmodel)
    model = GaussianModel.from_numpy(jmodel)
    img, _ = render(model.to_cloud(0), cam.default_camera(w, h, **kw), w, h,
                    cfg)
    val = loss.photometric_loss(img, target, 0.2)
    val.backward()
    assert val.item() == pytest.approx(float(jval), rel=1e-5)
    names = [f for f in PARAMS if getattr(model, f).numel()]
    stats = grad_parity([getattr(model, f).grad for f in names],
                        [np.asarray(getattr(jg, f)) for f in names])
    assert grad_parity_ok(stats, extra=2), stats
    assert model.sh_rest.grad.abs().max() == 0   # masked to SH degree 0


def _orbit_views(target, w, h, cfg, n_views, radius=4.0, y=0.5, step=0.5):
    views = []
    with torch.no_grad():
        for i in range(n_views):
            a = i * step
            camera = cam.default_camera(
                w, h, eye=(radius * np.sin(a), y, -radius * np.cos(a)),
                center=(0, 0, 0))
            img, _ = render(target, camera, w, h, cfg)
            views.append(View(camera=camera, image=img.numpy(), name=f"v{i}"))
    return views


def test_train_loop_overfits_and_densifies():
    """tests/test_train_loop.py's recipe on the port."""
    cfg = RenderConfig(max_dup=32, max_per_tile=64)
    views = _orbit_views(_port_cloud(make_random_cloud(24, seed=1)), 32, 32,
                         cfg, 3)
    start = GaussianModel.from_cloud(_port_cloud(make_random_cloud(24, seed=2)))
    logs = []
    state, dstate = train(
        start, views, 32, 32, render_config=cfg,
        loop=TrainLoopConfig(
            iterations=60, densify_from=10, densify_until=50,
            densify_every=20, opacity_reset_every=10_000,
            sh_upgrade_every=10_000, log_every=10, capacity_factor=3.0,
            grad_threshold=1e-6),
        on_log=lambda it, l, alive: logs.append((it, l, alive)),
        device="cpu")
    assert [it for it, _, _ in logs] == list(range(10, 61, 10))
    assert np.isfinite(logs[-1][1]) and logs[-1][1] < logs[0][1]
    assert logs[-1][2] > logs[0][2]          # densification grew it
    assert state.step == 60
    final = compact(state.model, dstate)
    assert final.num_gaussians == int(dstate.alive.sum())
    with torch.no_grad():
        img, _ = render(final.to_cloud(), views[0].camera, 32, 32, cfg)
    assert torch.isfinite(img).all()
    assert 0.5 < scene_extent(views) < 20.0


def test_train_from_random_init_reaches_psnr_floor():
    """tests/test_train_quality.py's recipe and floors on the port: 150
    iterations from a random init, ≥ 21 dB and ≥ 3 dB over the init."""
    w, h = 48, 36
    cfg = RenderConfig(max_dup=32, max_per_tile=96)
    views = _orbit_views(_port_cloud(make_random_cloud(48, seed=7)), w, h,
                         cfg, 4, y=0.4, step=np.pi / 2)
    start = GaussianModel.from_cloud(
        _port_cloud(make_random_cloud(48, seed=42)))

    def mean_psnr(model):
        with torch.no_grad():
            return np.mean([loss.psnr(render(model.to_cloud(), v.camera, w, h,
                                             cfg)[0], v.image)
                            for v in views])

    init = mean_psnr(start)
    state, dstate = train(
        start, views, w, h, render_config=cfg,
        loop=TrainLoopConfig(
            iterations=150, densify_from=30, densify_until=120,
            densify_every=30, opacity_reset_every=10_000,
            sh_upgrade_every=10_000, capacity_factor=4.0, log_every=50),
        on_log=lambda *a: None, device="cpu")
    final = mean_psnr(compact(state.model, dstate))
    assert final > init + 3.0, (init, final)
    assert final > 21.0, final


def test_checkpoint_roundtrip(tmp_path):
    cfg = RenderConfig(max_dup=16, max_per_tile=64)
    views = _orbit_views(_port_cloud(make_random_cloud(10, seed=3)), 24, 24,
                         cfg, 2)
    start = GaussianModel.from_cloud(_port_cloud(make_random_cloud(10, seed=4)))
    loop = TrainLoopConfig(iterations=6, densify_from=4, densify_every=4,
                           grad_threshold=1e-7, log_every=100)
    ckpt = str(tmp_path / "ckpt")
    state, dstate = train(start, views, 24, 24, cfg, loop, device="cpu",
                          checkpoint_dir=ckpt, checkpoint_every=6)
    assert has_checkpoint(ckpt)
    fresh, fresh_d = pad_to_capacity(GaussianModel.from_cloud(
        _port_cloud(make_random_cloud(10, seed=8))), 40)
    fresh_state = TrainState(fresh, make_optimizer(fresh))
    got, got_d, it = restore_loop_state(ckpt, fresh_state, fresh_d)
    assert it == 6 and got.step == state.step == 6
    for f in PARAMS:
        assert torch.equal(getattr(got.model, f), getattr(state.model, f))
        st_a = got.optimizer.state[getattr(got.model, f)]
        st_b = state.optimizer.state[getattr(state.model, f)]
        assert torch.equal(st_a["exp_avg_sq"], st_b["exp_avg_sq"])
    assert torch.equal(got_d.alive, dstate.alive)
    assert got.optimizer.param_groups[0]["lr_decay"] == \
        state.optimizer.param_groups[0]["lr_decay"]

    ply = str(tmp_path / "m.ply")
    save_ply(state, ply)
    back = load_ply_model(ply, device="cpu")
    assert back.num_gaussians == 40 and back.max_sh_degree == 0
    np.testing.assert_array_equal(back.xyz.detach().numpy(),
                                  state.model.xyz.detach().numpy())


def _png_filtered(img: np.ndarray, kinds) -> bytes:
    """PNG bytes of a uint8 [H, W, C] image, row y filtered with
    kinds[y % len(kinds)] (the encoder side of the five PNG filters)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        kind = kinds[y % len(kinds)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, up_left))
        out.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 2: 4, 3: 2, 4: 6}[c],
                       0, 0, 0)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND",
                                                                   b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_decoder_roundtrip(channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, size=(7, 9, channels), dtype=np.uint8)
    np.testing.assert_array_equal(read_png(_png_filtered(img, [0, 1, 2, 3,
                                                               4])), img)
    if channels != 2:                        # the port's own encoder
        np.testing.assert_array_equal(read_png(_png_bytes(img)), img)


def _write_capture(tmp_path, n_views=3, w=32, h=24):
    """An INRIA-style capture (PNGs + cameras.json) rendered by the port."""
    cfg = RenderConfig(max_dup=16, max_per_tile=64)
    cloud = _port_cloud(make_random_cloud(16, seed=4))
    imgdir = tmp_path / "images"
    imgdir.mkdir()
    entries = []
    for i in range(n_views):
        a = i * 0.7
        camera = cam.default_camera(
            w, h, eye=(3 * math.sin(a), 0.3, -3 * math.cos(a)),
            center=(0, 0, 0))
        with torch.no_grad():
            img, _ = render(cloud, camera, w, h, cfg)
        write_png(img.numpy(), str(imgdir / f"view{i}.png"))
        r_w2c = camera.view.numpy()[:3, :3]
        entries.append({
            "id": i, "img_name": f"view{i}", "width": w, "height": h,
            "position": camera.cam_pos.numpy().tolist(),
            "rotation": r_w2c.T.tolist(),
            "fx": float(camera.focal[0]), "fy": float(camera.focal[1])})
    camfile = tmp_path / "cameras.json"
    camfile.write_text(json.dumps(entries))
    return cloud, str(camfile), str(imgdir)


def test_load_dataset_matches_jax(tmp_path):
    _, camfile, imgdir = _write_capture(tmp_path)
    got = load_dataset(camfile, imgdir, 32, 24)
    ref = jax_load_dataset(camfile, imgdir, 32, 24)
    assert [v.name for v in got] == [v.name for v in ref]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.image, r.image)
        np.testing.assert_array_equal(g.camera.view.numpy(),
                                      np.asarray(r.camera.view))
    assert scene_extent(got) == pytest.approx(jax_scene_extent(ref), rel=1e-6)
    # another size, and a file that is not .png, go through pillow as in
    # the JAX package (tests/test_torch_dataset_eval.py: real JPEGs)
    os.rename(os.path.join(imgdir, "view0.png"),
              os.path.join(imgdir, "view0.jpg"))
    for w, h in ((16, 12), (32, 24)):
        got = load_dataset(camfile, imgdir, w, h)
        ref = jax_load_dataset(camfile, imgdir, w, h)
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.image, r.image)


def test_cli_train_cpu_writes_loadable_ply(tmp_path, capsys):
    _, camfile, imgdir = _write_capture(tmp_path)
    init = tmp_path / "init.ply"
    write_ply(_port_cloud(make_random_cloud(16, seed=5)), str(init))
    out = tmp_path / "trained.ply"
    base = ["train", "--ply", str(init), "--cameras", camfile, "--images",
            imgdir, "--out", str(out), "--width", "32", "--height", "24",
            "--max-dup", "16", "--max-per-tile", "64", "--device", "cpu",
            "--checkpoint", str(tmp_path / "ckpt"), "--checkpoint-every", "4"]
    cli_main(base + ["--iterations", "8"])
    trained = read_ply(str(out), device="cpu")
    assert 1 <= trained.num_gaussians <= 64
    assert torch.isfinite(trained.xyz).all()
    cli_main(base + ["--iterations", "12"])   # resumes at iteration 8
    assert "resumed from" in capsys.readouterr().err


def test_train_without_gpu_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, camfile, imgdir = _write_capture(tmp_path, n_views=1)
    views = load_dataset(camfile, imgdir, 32, 24)
    model = GaussianModel.from_cloud(_port_cloud(make_random_cloud(4)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(model, views, 32, 24)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["train", "--cameras", camfile, "--images", imgdir,
                  "--out", str(tmp_path / "o.ply"), "--width", "32",
                  "--height", "24", "--iterations", "1"])
    assert not (tmp_path / "o.ply").exists()
