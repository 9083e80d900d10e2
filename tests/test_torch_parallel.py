"""Tile-sharded rendering and training of the port (`parallel/`) against
the JAX package's `parallel/`, and the tile-list compositor they run
(`ops/rasterize.py::composite_tiles_auto`) against the full-frame twins.

The sharded checks run in one gloo process group of 4 ranks per module
(`torch.multiprocessing.spawn`, a `file://` store). The JAX results are
computed in the parent on a 4-device slice of the virtual CPU mesh and
handed to the children as numpy arrays; the children import no jax (the
module imports jax only inside its test functions) and send their results
back through files. Tolerances are the JAX tests' own
(`tests/test_parallel.py`): images atol 1e-5, parameters after one Adam
step atol 1e-4, and the loss to rel 1e-5.
"""

import dataclasses
import datetime
import os
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core import camera as cam
from gaussian_splatting_web_tpu_torch.core.types import GaussianCloud
from gaussian_splatting_web_tpu_torch.models.gaussian_model import (
    PARAMS,
    GaussianModel,
)
from gaussian_splatting_web_tpu_torch.ops.cuda import raster as raster_cuda
from gaussian_splatting_web_tpu_torch.ops.projection import project_gaussians
from gaussian_splatting_web_tpu_torch.ops.rasterize import (
    composite_backward_plain,
    composite_image_plain,
    composite_tiles_auto,
    composite_tiles_backward_plain,
    pack_splat_fields,
    render,
    tile_major,
)
from gaussian_splatting_web_tpu_torch.ops.sort import bin_splats
from gaussian_splatting_web_tpu_torch.parallel import (
    make_mesh,
    make_sharded_train_step,
    render_sharded,
)
from gaussian_splatting_web_tpu_torch.parallel.mesh import mesh_shape
from gaussian_splatting_web_tpu_torch.parallel.render_sharded import (
    _padded_tile_ids,
    shard_tile_ids,
)
from gaussian_splatting_web_tpu_torch.train.trainer import TrainState

# the JAX parallel tests' configuration and frame (tests/test_parallel.py)
CFG = RenderConfig(max_dup=64, max_per_tile=64, tile_chunk=2)
# the JAX package's default packed and tiered modes on the same caps
CFG_P = CFG.replace(depth_bits=19, tier_split=2, pack_fields=True,
                    pack_mean16=True, pack_grads=True)
W, H = 64, 48
WORLD = 4
EYES = ((0, 0, -6), (0, 1, -6))
MESHES = {"tile4": dict(tile=4), "data2xtile2": dict(data=2, tile=2)}
SPAWN_TIMEOUT_S = 300    # the group takes ~10 s; a hang fails the test


def _camera(eye):
    return cam.default_camera(W, H, eye=eye, center=(0, 0, 0))


def _cloud(arrays) -> GaussianCloud:
    return GaussianCloud(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def _worker(rank, folder):
    """One rank of the gloo group: mesh layouts, render_sharded on both
    meshes, one sharded train step on data=2 × tile=2. The inputs come
    from <folder>/inputs.pt (arguments of the spawn would be written down
    each child's pipe one after another, so the children would start in
    turn), the results go to <folder>/rank<r>.pt."""
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(folder, "inputs.pt"), weights_only=False)
    scenes, model0 = inputs["scenes"], inputs["model0"]
    targets = inputs["targets"]
    dist.init_process_group("gloo",
                            init_method=f"file://{folder}/store",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        res = {}
        m = make_mesh()
        res["default"] = (m.shape, m.data_index, m.tile_index)
        try:
            make_mesh(data=3, tile=3)
        except ValueError:
            res["refused_3x3"] = True
        for name, kw in MESHES.items():
            mesh = make_mesh(**kw)
            res[f"coords_{name}"] = (mesh.shape, mesh.data_index,
                                     mesh.tile_index)
            rgb, alpha = render_sharded(_cloud(scenes[name]),
                                        _camera(EYES[0]), W, H, mesh, CFG)
            res[f"rgb_{name}"] = rgb.numpy()
            res[f"alpha_{name}"] = alpha.numpy()
        rgb, alpha = render_sharded(_cloud(scenes["tile4"]), _camera(EYES[0]),
                                    W, H, make_mesh(tile=4), CFG_P)
        res["rgba_packed"] = torch.cat([rgb, alpha[..., None]], -1).numpy()
        mesh = make_mesh(**MESHES["data2xtile2"])
        model = GaussianModel.from_numpy(types.SimpleNamespace(**model0))
        state = TrainState(model, torch.optim.Adam(model.parameters(),
                                                   lr=1e-3))
        step = make_sharded_train_step(W, H, mesh, CFG, lambda_dssim=0.2)
        state, loss = step(state, [_camera(e) for e in EYES],
                           torch.from_numpy(targets))
        res["loss"] = float(loss)
        res["params"] = model.to_numpy()
        torch.save(res, os.path.join(folder, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _jax_config(cfg=CFG):
    from gaussian_splatting_web_tpu.config import RenderConfig as JaxConfig

    return JaxConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("args", [(12, 8, 2), (12, 5, 1), (8160, 4, 32)])
def test_padded_tile_ids_match_jax(args):
    from gaussian_splatting_web_tpu.parallel.render_sharded import (
        _padded_tile_ids as jax_padded,
    )

    ids, per = _padded_tile_ids(*args)
    jids, jper = jax_padded(*args)
    assert per == jper and ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    num_tiles, n_shards, chunk = args
    strips = [shard_tile_ids(num_tiles, n_shards, chunk, s)
              for s in range(n_shards)]
    real = torch.cat(strips)
    real = real[real < num_tiles]
    # every tile exactly once; the rest is the sentinel
    assert torch.equal(torch.sort(real).values,
                       torch.arange(num_tiles, dtype=torch.int32))
    for s, strip in enumerate(strips):
        keep = strip < num_tiles
        assert torch.equal(strip[keep], ids[s * per:(s + 1) * per][keep])


def test_mesh_shapes_without_a_group():
    assert mesh_shape(8) == (1, 8)
    assert mesh_shape(8, data=2) == (2, 4)
    assert mesh_shape(8, tile=2) == (4, 2)
    with pytest.raises(ValueError):
        mesh_shape(8, data=3, tile=3)
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "tile": 1} and mesh.tile_group is None
    with pytest.raises(ValueError):
        make_mesh(data=2)


def _binned(seed=3, w=72, h=40):
    rng = np.random.default_rng(seed)
    n = 120
    q = rng.normal(size=(n, 4)).astype(np.float32)
    cloud = GaussianCloud.from_numpy(types.SimpleNamespace(
        xyz=rng.normal(size=(n, 3)),
        log_scale=rng.uniform(-3.5, -1.5, (n, 3)),
        quat=q / np.linalg.norm(q, axis=1, keepdims=True),
        opacity_logit=rng.uniform(-2, 2, n),
        sh=rng.normal(scale=0.3, size=(n, 1, 3))))
    camera = cam.default_camera(w, h, eye=(0.3, 0.2, -5), center=(0, 0, 0))
    return cloud, camera, w, h


def test_tile_list_twins_match_full_frame():
    """The plain composite_tiles_auto over two sentinel-padded strips of a
    ragged 72x40 frame against the full-frame twins: each strip's tiles are
    the full frame's on the pixels inside it, the sentinel slots are empty,
    the two strips' backward rows add up to the full frame's, and the
    gradient through CompositeFn over the tile lists equals its gradient
    over the frame."""
    cloud, camera, w, h = _binned()
    cfg = RenderConfig(max_dup=16, max_per_tile=64)
    gx, gy = cfg.grid_size(w, h)
    t = gx * gy
    splats = project_gaussians(cloud, camera, w, h, cfg)
    bins = bin_splats(splats, w, h, cfg)
    fields = pack_splat_fields(splats).detach().requires_grad_(True)
    full = composite_image_plain(fields, bins, w, h, cfg)
    ref_tiles = tile_major(torch.cat([full.rgb, full.alpha[..., None]], -1),
                           gx, gy, 16).detach()
    inside = tile_major(torch.ones((h, w, 1)), gx, gy, 16)[..., 0] > 0

    strips = [shard_tile_ids(t, 2, 3, s) for s in range(2)]
    assert all(int((s == t).sum()) > 0 for s in strips)    # padded
    gen = torch.Generator().manual_seed(0)
    d_rgb = torch.randn((h, w, 3), generator=gen)
    d_alpha = torch.randn((h, w), generator=gen)
    cot = tile_major(torch.cat([d_rgb, d_alpha[..., None]], -1), gx, gy, 16)
    rows = 0
    for ids in strips:
        out = raster_cuda.composite_forward(fields.detach(), bins, w, h,
                                            cfg, tile_ids=ids)
        real = ids < t
        got = out.rgba[real]
        want = ref_tiles[ids[real].long()]
        keep = inside[ids[real].long()]
        np.testing.assert_allclose(got[keep].numpy(), want[keep].numpy(),
                                   atol=1e-6)
        assert not out.rgba[~real].any() and (out.last_idx[~real] == -1).all()
        d_list = torch.where(real[:, None, None],
                             cot[ids.clamp(max=t - 1).long()], 0.0)
        rows = rows + composite_tiles_backward_plain(
            fields.detach(), bins, ids, w, h, cfg, out.last_idx, d_list)
    full_rows = composite_backward_plain(fields.detach(), bins, w, h, cfg,
                                         full, d_rgb, d_alpha)
    assert full_rows.abs().max() > 0
    np.testing.assert_allclose(rows.numpy(), full_rows.numpy(), rtol=1e-5,
                               atol=1e-7)

    # autograd: CompositeFn over the stitched strips vs over the frame
    weight = torch.rand((h, w, 4), generator=gen)
    frame = raster_cuda.composite_image(fields, bins, w, h, cfg)
    full_img = torch.cat([frame.rgb, frame.alpha[..., None]], -1)
    (g_full,) = torch.autograd.grad((full_img * weight).sum(), fields)
    tiles = torch.zeros((t, 256, 4))
    for ids in strips:
        sub = composite_tiles_auto(splats, ids, w, h, cfg, gx)
        assert sub.shape == (ids.shape[0], 16, 16, 4)
        real = ids < t
        tiles = tiles.index_copy(0, ids[real].long(),
                                 raster_cuda.composite_tiles_subset(
                                     fields, bins, ids, w, h, cfg)[real])
    img = tiles.reshape(gy, gx, 16, 16, 4).permute(0, 2, 1, 3, 4).reshape(
        gy * 16, gx * 16, 4)[:h, :w]
    (g_list,) = torch.autograd.grad((img * weight).sum(), fields)
    # the twins sum over chunks of other shapes: 1e-6 of the largest
    np.testing.assert_allclose(g_list.numpy(), g_full.numpy(), rtol=0,
                               atol=1e-6 * float(g_full.abs().max()))


def test_tile_ids_checks():
    """The wrappers' one host sync refuses ids out of range and a repeated
    real id (two blocks of kernel B would store the same rows); the
    sentinel may repeat."""
    cloud, camera, w, h = _binned()
    cfg = RenderConfig(max_dup=16, max_per_tile=64)
    t = cfg.num_tiles(w, h)
    splats = project_gaussians(cloud, camera, w, h, cfg)
    bins = bin_splats(splats, w, h, cfg)
    fields = pack_splat_fields(splats)

    def check(ids):
        return raster_cuda._check_inputs(fields, bins, w, h, cfg,
                                         torch.tensor(ids, dtype=torch.int32))

    check([0, 3, t, t])
    with pytest.raises(ValueError, match="more than once"):
        check([0, 3, 3])
    with pytest.raises(ValueError, match="outside"):
        check([0, t + 1])
    with pytest.raises(ValueError, match="outside"):
        check([-1, 2])
    with pytest.raises(TypeError):
        raster_cuda._check_inputs(fields, bins, w, h, cfg,
                                  torch.tensor([0, 1]))


def test_sharded_render_and_train_match_jax(tmp_path):
    """4 gloo ranks: render_sharded on tile=4 and on data=2 × tile=2 (and
    on tile=4 under the packed and tiered modes, CFG_P), and one
    make_sharded_train_step step on data=2 × tile=2, against the JAX
    package's on a 4-device mesh (the scenes of tests/test_parallel.py).
    The sharded images are held to the port's own single-device render at
    the JAX test's atol 1e-5, and to the JAX package's by the repo's image
    rule (`assert_images_close`): the port's single-device render of these
    scenes is already up to 2e-5 off the JAX package's (exp and log1p
    rounded by another library)."""
    import jax
    import jax.numpy as jnp
    import optax

    from gaussian_splatting_web_tpu.core import camera as jax_camera
    from gaussian_splatting_web_tpu.core.types import stack_cameras
    from gaussian_splatting_web_tpu.models.gaussian_model import (
        GaussianModel as JaxModel,
    )
    from gaussian_splatting_web_tpu.ops.rasterize import render as jax_render
    from gaussian_splatting_web_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh,
    )
    from gaussian_splatting_web_tpu.parallel.render_sharded import (
        render_sharded as jax_render_sharded,
    )
    from gaussian_splatting_web_tpu.parallel.train_sharded import (
        make_sharded_train_step as jax_sharded_step,
    )
    from gaussian_splatting_web_tpu.train.trainer import init_train_state
    from tests.conftest import assert_images_close, make_random_cloud

    jcfg = _jax_config()
    devices = jax.devices()[:WORLD]
    jcams = [jax_camera.default_camera(W, H, eye=e, center=(0, 0, 0))
             for e in EYES]
    sharded = jax.jit(jax_render_sharded, static_argnums=(2, 3, 4, 5))
    scenes, want, single = {}, {}, {}
    for name, n, seed, sh in (("tile4", 40, 0, 1), ("data2xtile2", 24, 1, 0)):
        jcloud = make_random_cloud(n, seed=seed, sh_degree=sh)
        scenes[name] = {f: np.asarray(getattr(jcloud, f))
                        for f in ("xyz", "log_scale", "quat",
                                  "opacity_logit", "sh")}
        rgb, alpha = sharded(jcloud, jcams[0], W, H,
                             jax_make_mesh(devices, **MESHES[name]), jcfg)
        want[name] = np.concatenate([rgb, alpha[..., None]], -1)
        with torch.no_grad():
            img, aux = render(_cloud(scenes[name]), _camera(EYES[0]), W, H,
                              CFG)
        single[name] = torch.cat([img, aux["alpha"][..., None]], -1).numpy()
    # the packed and tiered modes (CFG_P) on tile=4
    rgb, alpha = sharded(make_random_cloud(40, seed=0, sh_degree=1), jcams[0],
                         W, H, jax_make_mesh(devices, **MESHES["tile4"]),
                         _jax_config(CFG_P))
    want["packed"] = np.concatenate([rgb, alpha[..., None]], -1)
    with torch.no_grad():
        img, aux = render(_cloud(scenes["tile4"]), _camera(EYES[0]), W, H,
                          CFG_P)
    single["packed"] = torch.cat([img, aux["alpha"][..., None]], -1).numpy()

    jmodel = JaxModel.from_cloud(make_random_cloud(24, seed=3, sh_degree=0))
    render_t = jax.jit(jax_render, static_argnums=(2, 3, 4))
    targets = jnp.stack([render_t(make_random_cloud(24, seed=9), c, W, H,
                                  jcfg)[0] for c in jcams])
    opt = optax.adam(1e-3)
    step = jax_sharded_step(opt, W, H,
                            jax_make_mesh(devices, **MESHES["data2xtile2"]),
                            jcfg, lambda_dssim=0.2)
    jstate, jloss = step(init_train_state(jmodel, opt), stack_cameras(jcams),
                         targets)
    model0 = {f: np.asarray(getattr(jmodel, f)) for f in PARAMS}

    torch.save({"scenes": scenes, "model0": model0,
                "targets": np.asarray(targets)}, tmp_path / "inputs.pt")
    ctx = mp.spawn(_worker, nprocs=WORLD, join=False,
                   args=(str(tmp_path),))
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"the gloo group did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    results = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
               for r in range(WORLD)]
    for r, res in enumerate(results):
        assert res["default"] == ({"data": 1, "tile": 4}, 0, r)
        assert res["refused_3x3"]
        assert res["coords_data2xtile2"] == ({"data": 2, "tile": 2}, r // 2,
                                             r % 2)
        for name in MESHES:
            rgba = np.concatenate([res[f"rgb_{name}"],
                                   res[f"alpha_{name}"][..., None]], -1)
            assert_images_close(rgba, want[name])
            np.testing.assert_allclose(rgba, single[name], atol=1e-5,
                                       err_msg=name)
        assert_images_close(res["rgba_packed"], want["packed"])
        np.testing.assert_allclose(res["rgba_packed"], single["packed"],
                                   atol=1e-5, err_msg="packed")
        assert res["loss"] == pytest.approx(float(jloss), rel=1e-5)
        for f in PARAMS:
            np.testing.assert_allclose(
                res["params"][f], np.asarray(getattr(jstate.params, f)),
                atol=1e-4, err_msg=f)
            # replicated: every rank holds the same parameters
            np.testing.assert_array_equal(res["params"][f],
                                          results[0]["params"][f])
