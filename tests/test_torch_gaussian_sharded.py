"""Gaussian sharding of the port (`parallel/gaussian_sharded.py`) against
the JAX package's `parallel/gaussian_sharded.py`.

The 4-rank checks run in one gloo process group per test
(`torch.multiprocessing.spawn`, a `file://` store), as in
`tests/test_torch_parallel.py`: the JAX results are computed in the parent
on a 4-device slice of the virtual CPU mesh and handed to the children as
numpy arrays, the children import no jax, and results come back through
files. Tolerances are the JAX tests' (`tests/test_parallel.py:107-320`):
sharded images equal the single-device render to atol 1e-5 (ring) and
2e-5 (banded), the loss atol 1e-5, parameters after one Adam step atol
1e-4. As in `tests/test_torch_parallel.py`, the sharded images are held
to the port's own single-device render at those tolerances and to the
JAX package's sharded images by the repo's image rule
(`assert_images_close`): the port's single-device render is already up to
3e-5 off the JAX package's on these scenes (exp and log1p rounded by
another library). Where the banded candidates overflow their
cap the images depend on the candidate order by design, so only the
overflow counts are compared there (they do not).
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
from gaussian_splatting_web_tpu_torch.ops.rasterize import render
from gaussian_splatting_web_tpu_torch.parallel import (
    banded_band_tiles,
    banded_cap_hop,
    banded_tile_rows,
    init_sharded_train_state,
    make_gaussian_sharded_train_step,
    make_mesh,
    render_gaussian_sharded,
    render_gaussian_sharded_banded,
    ring_all_gather,
    shard_model,
)
from gaussian_splatting_web_tpu_torch.parallel.gaussian_sharded import (
    _pack_splat_rows,
    _unpack_splat_rows,
)
from gaussian_splatting_web_tpu_torch.ops.projection import project_gaussians
from gaussian_splatting_web_tpu_torch.train.loss import photometric_loss
from gaussian_splatting_web_tpu_torch.train.trainer import TrainState

CFG = RenderConfig(max_dup=64, max_per_tile=64, tile_chunk=2)
W, H = 64, 48          # the ring's frame (tests/test_parallel.py)
WB, HB = 64, 128       # the banded frame: gy = 8 ≥ 4 bands
WORLD = 4
EYES = ((0, 0, -6), (0, 1, -6))
MESHES = {"tile4": dict(tile=4), "data2xtile2": dict(data=2, tile=2)}
# banded scenes: 2,048 splats (n_s 512 at S = 4); cand_factor 3.0 gives
# cap_hop 384 < 512 with no overflow, the crowded scene (spread 0.3) at
# cand_factor 0.5 (cap_hop at its 256 floor) overflows
BANDED = {"exact": (1.0, 3.0), "crowded": (0.3, 0.5)}
STREAMS = ("a2a", "ring")
# train variants: (banded, stream)
VARIANTS = {"ring": (False, "a2a"), "a2a": (True, "a2a"),
            "ring_stream": (True, "ring")}
SPAWN_TIMEOUT_S = 300


def _camera(w, h, eye=EYES[0]):
    return cam.default_camera(w, h, eye=eye, center=(0, 0, 0))


def _cloud(arrays) -> GaussianCloud:
    return GaussianCloud(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def _adam(model):
    return torch.optim.Adam(model.parameters(), lr=1e-3)


def _scene_arrays(jcloud):
    return {f: np.asarray(getattr(jcloud, f))
            for f in ("xyz", "log_scale", "quat", "opacity_logit", "sh")}


def _jax_config():
    from gaussian_splatting_web_tpu.config import RenderConfig as JaxConfig

    return JaxConfig(**dataclasses.asdict(CFG))


def _run_group(worker, folder, inputs):
    """Spawn the 4-rank gloo group on `worker`, inputs through a file →
    each rank's results."""
    torch.save(inputs, os.path.join(folder, "inputs.pt"))
    ctx = mp.spawn(worker, nprocs=WORLD, join=False, args=(str(folder),))
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"the gloo group did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    return [torch.load(os.path.join(folder, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def _join(rank, folder):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{folder}/store",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    return torch.load(os.path.join(folder, "inputs.pt"), weights_only=False)


def _render_worker(rank, folder):
    """ring_all_gather, the ring render and the banded renders (both
    streams, both scenes) on tile=4."""
    inputs = _join(rank, folder)
    try:
        res = {}
        mesh = make_mesh(tile=4)
        x = torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3)
        res["gather"] = ring_all_gather(x[rank * 4:(rank + 1) * 4],
                                        mesh).numpy()
        rgb, alpha = render_gaussian_sharded(
            shard_model(_cloud(inputs["ring"]), mesh), _camera(W, H), W, H,
            mesh, CFG)
        res["ring"] = torch.cat([rgb, alpha[..., None]], -1).numpy()
        for name, (_, cf) in BANDED.items():
            shard = shard_model(_cloud(inputs[name]), mesh)
            for stream in STREAMS:
                rgb, alpha, over = render_gaussian_sharded_banded(
                    shard, _camera(WB, HB), WB, HB, mesh, CFG,
                    cand_factor=cf, stream=stream)
                res[f"{name}_{stream}"] = torch.cat(
                    [rgb, alpha[..., None]], -1).numpy()
                res[f"{name}_{stream}_over"] = int(over)
        torch.save(res, os.path.join(folder, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _train_worker(rank, folder):
    """One step of every variant on both meshes; each rank returns its
    shard's parameters after the step and the rows of its Adam moments."""
    inputs = _join(rank, folder)
    try:
        res = {}
        for mname, kw in MESHES.items():
            mesh = make_mesh(**kw)
            for vname, (banded, stream) in VARIANTS.items():
                sc = inputs["banded" if banded else "ring"]
                w, h = (WB, HB) if banded else (W, H)
                model = GaussianModel.from_numpy(
                    types.SimpleNamespace(**sc["model0"]))
                state = init_sharded_train_state(model, mesh, _adam)
                step = make_gaussian_sharded_train_step(
                    w, h, mesh, CFG, lambda_dssim=0.2, banded=banded,
                    stream=stream)
                state, loss, aux = step(
                    state, [_camera(w, h, e) for e in EYES],
                    torch.from_numpy(sc["targets"]))
                moments = {v.shape[0] for st in state.optimizer.state.values()
                           for v in st.values() if v.dim()}
                first = {f: state.optimizer.state[getattr(state.model, f)]
                         ["exp_avg"].numpy() for f in PARAMS}
                res[mname, vname] = dict(
                    loss=float(loss), overflow=int(aux["overflow"]),
                    params=state.model.to_numpy(), first=first,
                    rows=state.model.num_gaussians, moments=moments,
                    coords=(mesh.data_index, mesh.tile_index))
        torch.save(res, os.path.join(folder, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_gaussian_sharded_renders_match_jax(tmp_path):
    """4 gloo ranks on tile=4 against the JAX package on a 4-device mesh:
    ring_all_gather exactly; the ring render (40 splats, 64x48) at atol
    1e-5; the banded render of 2,048 splats at 64x128 on both streams with
    overflow 0 at atol 2e-5 (against the port's single-device render, and
    to the JAX images by the image rule); and on a crowded scene whose
    candidates overflow their cap, the overflow counts of both streams."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from gaussian_splatting_web_tpu.core import camera as jax_camera
    from gaussian_splatting_web_tpu.parallel import gaussian_sharded as jgs
    from gaussian_splatting_web_tpu.parallel.mesh import AXES
    from gaussian_splatting_web_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh,
    )
    from tests.conftest import assert_images_close, make_random_cloud

    def single(arrays, w, h):
        with torch.no_grad():
            img, aux = render(_cloud(arrays), _camera(w, h), w, h, CFG)
        return torch.cat([img, aux["alpha"][..., None]], -1).numpy()

    jcfg = _jax_config()
    jmesh = jax_make_mesh(jax.devices()[:WORLD], tile=4)
    x = jnp.arange(16 * 3, dtype=jnp.float32).reshape(16, 3)
    gathered = shard_map(lambda blk: jgs.ring_all_gather(blk, AXES.tile, 4),
                         mesh=jmesh, in_specs=P(AXES.tile), out_specs=P(),
                         check_vma=False)(x)
    want = {"gather": np.asarray(gathered)}
    inputs = {}
    jcloud = make_random_cloud(40, seed=0, sh_degree=1)
    inputs["ring"] = _scene_arrays(jcloud)
    rgb, alpha = jax.jit(jgs.render_gaussian_sharded,
                         static_argnums=(2, 3, 4, 5))(
        jcloud, jax_camera.default_camera(W, H, eye=EYES[0],
                                          center=(0, 0, 0)),
        W, H, jmesh, jcfg)
    want["ring"] = np.concatenate([rgb, alpha[..., None]], -1)
    alone = {"ring": single(inputs["ring"], W, H)}
    jcam = jax_camera.default_camera(WB, HB, eye=EYES[0], center=(0, 0, 0))
    for name, (spread, cf) in BANDED.items():
        jcloud = make_random_cloud(2048, seed=2, sh_degree=1, spread=spread)
        inputs[name] = _scene_arrays(jcloud)
        alone[name] = single(inputs[name], WB, HB)
        for stream in STREAMS:
            rgb, alpha, over = jax.jit(
                lambda c, cf=cf, stream=stream:
                jgs.render_gaussian_sharded_banded(
                    c, jcam, WB, HB, jmesh, jcfg, cand_factor=cf,
                    stream=stream))(jcloud)
            want[f"{name}_{stream}"] = np.concatenate(
                [rgb, alpha[..., None]], -1)
            want[f"{name}_{stream}_over"] = int(over)

    results = _run_group(_render_worker, tmp_path, inputs)
    assert want["exact_a2a_over"] == want["exact_ring_over"] == 0
    assert want["crowded_a2a_over"] > 0
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["gather"], want["gather"])
        np.testing.assert_array_equal(res["gather"], np.asarray(x))
        np.testing.assert_allclose(res["ring"], alone["ring"], atol=1e-5,
                                   err_msg=f"rank {r}")
        assert_images_close(res["ring"], want["ring"])
        for stream in STREAMS:
            assert res[f"exact_{stream}_over"] == 0
            np.testing.assert_allclose(res[f"exact_{stream}"],
                                       alone["exact"], atol=2e-5,
                                       err_msg=f"rank {r} {stream}")
            assert_images_close(res[f"exact_{stream}"],
                                want[f"exact_{stream}"])
            assert (res[f"crowded_{stream}_over"]
                    == want[f"crowded_{stream}_over"]), stream
            # every rank holds the same image
            np.testing.assert_array_equal(res[f"exact_{stream}"],
                                          results[0][f"exact_{stream}"])


def test_gaussian_sharded_train_steps_match_jax(tmp_path):
    """4 gloo ranks, one step of the ring, the banded a2a and the banded
    ring-stream variants on tile=4 and on data=2 × tile=2, against the JAX
    package's `make_gaussian_sharded_train_step` (ring and banded) on the
    same 4-device meshes, the scenes of tests/test_parallel.py: the loss
    at atol 1e-5, the parameters after one Adam step at atol 1e-4 and the
    gradient (Adam's first moment, optax's `mu` against torch's `exp_avg`)
    to 1e-3 of its largest entry, the shards put together in tile order. Each rank holds N/S parameter rows
    and N/S rows of Adam moments, and the data ranks hold equal shards."""
    import jax
    import jax.numpy as jnp
    import optax

    from gaussian_splatting_web_tpu.core import camera as jax_camera
    from gaussian_splatting_web_tpu.core.types import stack_cameras
    from gaussian_splatting_web_tpu.models.gaussian_model import (
        GaussianModel as JaxModel,
    )
    from gaussian_splatting_web_tpu.ops.rasterize import render as jax_render
    from gaussian_splatting_web_tpu.parallel import gaussian_sharded as jgs
    from gaussian_splatting_web_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh,
    )
    from tests.conftest import make_random_cloud

    jcfg = _jax_config()
    devices = jax.devices()[:WORLD]
    render_t = jax.jit(jax_render, static_argnums=(2, 3, 4))
    opt = optax.adam(1e-3)
    inputs, want = {}, {}
    for key, (n, seed, tseed, tn, w, h) in {
            "ring": (24, 3, 9, 24, W, H),
            "banded": (2048, 4, 11, 256, WB, HB)}.items():
        jmodel = JaxModel.from_cloud(make_random_cloud(n, seed=seed))
        jcams = [jax_camera.default_camera(w, h, eye=e, center=(0, 0, 0))
                 for e in EYES]
        targets = jnp.stack([render_t(make_random_cloud(tn, seed=tseed), c,
                                      w, h, jcfg)[0] for c in jcams])
        inputs[key] = {"model0": {f: np.asarray(getattr(jmodel, f))
                                  for f in PARAMS},
                       "targets": np.asarray(targets)}
        for mname, kw in MESHES.items():
            mesh = jax_make_mesh(devices, **kw)
            step = jgs.make_gaussian_sharded_train_step(
                opt, w, h, mesh, jcfg, lambda_dssim=0.2,
                banded=key == "banded", n_gaussians=n)
            state, loss, aux = step(
                jgs.init_sharded_train_state(jmodel, opt, mesh),
                stack_cameras(jcams), targets)
            mu = state.opt_state[0].mu      # optax adam: (1 - b1)·g
            want[mname, key] = (float(loss), int(aux["overflow"]),
                                {f: np.asarray(getattr(state.params, f))
                                 for f in PARAMS},
                                {f: np.asarray(getattr(mu, f))
                                 for f in PARAMS}, n)

    results = _run_group(_train_worker, tmp_path, inputs)
    for (mname, kw) in MESHES.items():
        n_tile = kw["tile"]
        for vname, (banded, _) in VARIANTS.items():
            loss, over, params, first, n = want[mname,
                                         "banded" if banded else "ring"]
            got = [res[mname, vname] for res in results]
            shards = {g["coords"]: g for g in got}
            for g in got:
                what = f"{mname} {vname} rank {g['coords']}"
                assert g["rows"] == n // n_tile, what
                assert g["moments"] == {n // n_tile}, what
                assert g["loss"] == pytest.approx(loss, abs=1e-5), what
                assert g["overflow"] == over == 0, what
                for f in PARAMS:
                    np.testing.assert_array_equal(
                        g["params"][f],
                        shards[0, g["coords"][1]]["params"][f])
            for f in PARAMS:
                whole = np.concatenate([shards[0, t]["params"][f]
                                        for t in range(n_tile)])
                np.testing.assert_allclose(whole, params[f], atol=1e-4,
                                           err_msg=f"{mname} {vname} {f}")
                mom = np.concatenate([shards[0, t]["first"][f]
                                      for t in range(n_tile)])
                # both moments are (1 - b1)·g after one step: the gradient
                # to 1e-3 of its largest entry, which a gradient summed
                # twice or missing 1/n_data fails by a factor 500
                np.testing.assert_allclose(
                    mom, first[f], rtol=0,
                    atol=1e-3 * np.abs(first[f]).max(initial=0.0),
                    err_msg=f"{mname} {vname} {f} first moment")


@pytest.mark.parametrize("w,h,s,chunk", [
    (64, 128, 4, 2), (64, 48, 4, 2), (72, 40, 3, 4), (1920, 1080, 4, 32)])
def test_banded_band_tiles_pad_with_the_sentinel(w, h, s, chunk):
    """The band lists against JAX `banded_band_tiles`: the same sizes and
    the same ids in every real slot; every padding slot, and every slot
    past the frame's last tile (64x48 at S = 4 leaves band 3 empty), holds
    the sentinel gx·gy where the JAX list repeats real tiles; each tile is
    listed exactly once."""
    from gaussian_splatting_web_tpu.parallel import gaussian_sharded as jgs

    cfg = CFG.replace(tile_chunk=chunk)
    gx, gy = cfg.grid_size(w, h)
    t = gx * gy
    ids, per_band, per_pad = banded_band_tiles(w, h, s, cfg)
    jids, jper_band, jper_pad = jgs.banded_band_tiles(w, h, s,
                                                      _jax_config().replace(
                                                          tile_chunk=chunk))
    assert (per_band, per_pad) == (jper_band, jper_pad)
    assert ids.dtype == torch.int32 and ids.shape == (s * per_pad,)
    k = torch.arange(s * per_pad) % per_pad
    real = (k < per_band) & (torch.arange(s * per_pad) // per_pad * per_band
                             + k < t)
    np.testing.assert_array_equal(ids[real].numpy(),
                                  np.asarray(jids)[real.numpy()])
    assert bool((ids[~real] == t).all())
    assert torch.equal(torch.sort(ids[real]).values,
                       torch.arange(t, dtype=torch.int32))


@pytest.mark.parametrize("n,s,gy,cf", [
    (2048, 4, 8, 2.5), (2048, 4, 8, 0.5), (128, 2, 3, 2.5),
    (1_000_000, 4, 68, 2.5), (1_000_000, 1, 68, 2.5)])
def test_banded_sizes_match_jax(n, s, gy, cf):
    from gaussian_splatting_web_tpu.parallel import gaussian_sharded as jgs

    assert banded_tile_rows(gy, s) == jgs.banded_tile_rows(gy, s)
    assert banded_cap_hop(n, s, cf) == jgs.banded_cap_hop(n, s, cf)


def test_shard_model_rows_and_refusal():
    """shard_model keeps tile rank t's rows [t·n_s, (t+1)·n_s) of a model
    or a cloud, and refuses N % S != 0 as the JAX function does."""
    rng = np.random.default_rng(0)
    n = 12
    model = GaussianModel.from_numpy(types.SimpleNamespace(
        xyz=rng.normal(size=(n, 3)), log_scale=rng.normal(size=(n, 3)),
        quat=rng.normal(size=(n, 4)), opacity_logit=rng.normal(size=n),
        sh_dc=rng.normal(size=(n, 1, 3)), sh_rest=rng.normal(size=(n, 3, 3))))
    mesh = dataclasses.replace(make_mesh(), shape={"data": 1, "tile": 3},
                               tile_index=1)
    shard = shard_model(model, mesh)
    assert isinstance(shard, GaussianModel) and shard.num_gaussians == 4
    for f in PARAMS:
        np.testing.assert_array_equal(getattr(shard, f).detach().numpy(),
                                      getattr(model, f).detach()[4:8].numpy())
    cloud = shard_model(model.to_cloud(), mesh)
    assert isinstance(cloud, GaussianCloud)
    assert torch.equal(cloud.sh, model.to_cloud().sh[4:8])
    state = init_sharded_train_state(model, mesh, _adam)
    assert state.model.num_gaussians == 4
    with pytest.raises(ValueError, match="not divisible"):
        shard_model(GaussianModel.from_numpy(types.SimpleNamespace(
            **{f: getattr(model, f).detach().numpy()[:11] for f in PARAMS})),
            mesh)


def _one_rank_scene(n=384, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    return GaussianCloud.from_numpy(types.SimpleNamespace(
        xyz=rng.normal(size=(n, 3)),
        log_scale=rng.uniform(-3.5, -1.5, (n, 3)),
        quat=q / np.linalg.norm(q, axis=1, keepdims=True),
        opacity_logit=rng.uniform(-2, 2, n),
        sh=rng.normal(scale=0.3, size=(n, 4, 3))))


def test_pack_splat_rows_round_trip():
    """The 16-column rows carry every field unchanged, the valid flag in
    column 11 and zeros in 12-15 (JAX `_pack_splat_rows`)."""
    cloud = _one_rank_scene()
    splats = project_gaussians(cloud, _camera(WB, HB), WB, HB, CFG)
    rows = _pack_splat_rows(splats)
    assert rows.shape == (cloud.num_gaussians, 16)
    back = _unpack_splat_rows(rows)
    for f in ("mean2d", "conic", "depth", "radius", "rgb", "opacity",
              "valid"):
        assert torch.equal(getattr(back, f), getattr(splats, f)), f
    assert not rows[:, 12:].any()
    assert torch.equal(rows[:, 11], splats.valid.to(torch.float32))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_one_rank_equals_unsharded_bit_for_bit(variant):
    """On a 1 × 1 mesh (no process group) the ring and both banded streams
    render `render`'s image bit for bit with overflow 0, and one step gives
    the unsharded loss and gradients bit for bit: the gather is a copy, and
    the a2a class sort with S = 1, bmax = 1 keeps every live splat in slot
    order (the one-card expectation of chip_smoke's phase 18)."""
    banded, stream = VARIANTS[variant]
    cloud = _one_rank_scene()
    mesh = make_mesh()
    camera = _camera(WB, HB)
    with torch.no_grad():
        img, aux = render(cloud, camera, WB, HB, CFG)
    if banded:
        rgb, alpha, over = render_gaussian_sharded_banded(
            cloud, camera, WB, HB, mesh, CFG, stream=stream)
        assert int(over) == 0
    else:
        rgb, alpha = render_gaussian_sharded(cloud, camera, WB, HB, mesh, CFG)
    assert torch.equal(rgb, img) and torch.equal(alpha, aux["alpha"])

    cams = [_camera(WB, HB, e) for e in EYES]
    with torch.no_grad():
        targets = torch.stack([0.8 * render(cloud, c, WB, HB, CFG)[0]
                               for c in cams])
    ref = GaussianModel.from_cloud(cloud)
    ref_loss = sum(photometric_loss(render(ref.to_cloud(), c, WB, HB, CFG)[0],
                                    t) for c, t in zip(cams, targets)) / 2
    ref_loss.backward()
    ref_loss = ref_loss.detach()
    model = GaussianModel.from_cloud(cloud)
    step = make_gaussian_sharded_train_step(WB, HB, mesh, CFG, banded=banded,
                                            stream=stream)
    _, loss, aux = step(TrainState(model, _adam(model)), cams, targets)
    assert float(loss) == float(ref_loss) and int(aux["overflow"]) == 0
    for f in PARAMS:
        assert torch.equal(getattr(model, f).grad, getattr(ref, f).grad), f


def _cli_scene(tmp_path, n=301):
    """An odd-sized scene (N % S != 0 for S = 2, 3, 4) as a PLY."""
    from gaussian_splatting_web_tpu_torch.io.ply import write_ply
    from gaussian_splatting_web_tpu_torch.parallel.dryrun import tiny_scene

    ply = str(tmp_path / "scene.ply")
    write_ply(tiny_scene(n), ply)
    return ply


def _png(folder):
    (name,) = os.listdir(folder)
    with open(os.path.join(folder, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("mode", ["ring", "banded"])
def test_cli_render_gaussian_sharded_one_rank(tmp_path, mode, capsys):
    """`render --gaussian-sharded[=banded]` without a process group: a
    1 × 1 mesh with a warning, and the PNG of the unsharded render."""
    from gaussian_splatting_web_tpu_torch import cli

    ply = _cli_scene(tmp_path)
    args = ["render", "--ply", ply, "--device", "cpu", "--width", "64",
            "--height", "48", "--tile-chunk", "4"]
    cli.main(args + ["--out", str(tmp_path / "plain")])
    cli.main(args + ["--out", str(tmp_path / mode),
                     f"--gaussian-sharded={mode}"])
    assert "1 x 1 mesh" in capsys.readouterr().err
    assert _png(tmp_path / mode) == _png(tmp_path / "plain")


def test_cli_render_gaussian_sharded_under_torchrun(tmp_path):
    """torchrun with 3 gloo ranks on the CPU: the 301 splats are padded to
    303 with dead gaussians, the banded render's PNG (written by rank 0
    alone) is the unsharded render's."""
    import socket
    import subprocess
    import sys

    from gaussian_splatting_web_tpu_torch import cli

    ply = _cli_scene(tmp_path)
    args = ["render", "--ply", ply, "--device", "cpu", "--width", "64",
            "--height", "128"]
    cli.main(args + ["--out", str(tmp_path / "plain")])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "3", "--master-addr", "127.0.0.1", "--master-port", str(port),
         "-m", "gaussian_splatting_web_tpu_torch.cli", *args, "--out",
         str(tmp_path / "sharded"), "--gaussian-sharded=banded"],
        cwd=root, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "gloo rank" in proc.stderr and "overflow=0" in proc.stderr
    assert _png(tmp_path / "sharded") == _png(tmp_path / "plain")
