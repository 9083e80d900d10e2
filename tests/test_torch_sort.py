"""Port bin_splats vs the JAX package's, fed the SAME projected splats
(converted from the JAX projection): tile offsets, counts, pair totals and
every tile's gaussian-id segment must be identical. Covers the plain
path, the centre shrink of oversized splats and the gather cap; and the
rule that sends CUDA tensors with single-tier duplication to the CUDA
kernels (`ops/cuda/bin.py`) and everything else to `bin_splats_plain`."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaussian_splatting_web_tpu.config import RenderConfig as JaxConfig
from gaussian_splatting_web_tpu.core import camera as jax_camera
from gaussian_splatting_web_tpu.core.types import numpy_cloud
from gaussian_splatting_web_tpu.ops.projection import (
    project_gaussians as jax_project,
)
from gaussian_splatting_web_tpu.ops.sort import bin_splats as jax_bin
from gaussian_splatting_web_tpu.ops.sort import (
    float_to_sortable_uint as jax_sortable,
)
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.ops.projection import ProjectedSplats
from gaussian_splatting_web_tpu_torch.ops.cuda import bin as bin_cuda
from gaussian_splatting_web_tpu_torch.ops.cuda import build
from gaussian_splatting_web_tpu_torch.ops.sort import (
    bin_splats,
    bin_splats_plain,
    float_to_sortable_uint,
    takes_kernels,
)
from tests.conftest import make_random_cloud

torch.set_num_threads(2)

W, H = 72, 40
BASE = RenderConfig(max_dup=16, max_per_tile=256)


def _scene(kind):
    cloud = numpy_cloud(make_random_cloud(180, seed=21, sh_degree=0,
                                          spread=1.2))
    cfg = BASE
    if kind == "shrink":
        # a few splats much larger than max_dup tiles, some half off-screen
        # (the 72x40 frame has only 15 tiles, so max_dup drops to 4)
        cfg = BASE.replace(max_dup=4)
        cloud.log_scale[:8] = 0.2
        cloud.xyz[:4, 0] += np.array([0.0, 2.5, -2.5, 1.0], np.float32)
    elif kind == "cap":
        cfg = BASE.replace(gather_cap_factor=0.5, gather_cap_floor=0)
    return cloud, cfg


def _projected(cloud, cfg):
    cam = jax_camera.default_camera(W, H, eye=(0.0, 0.0, -6.0))
    ref = jax_project(cloud, cam, W, H, JaxConfig(**dataclasses.asdict(cfg)))
    port = ProjectedSplats(**{
        f.name: torch.from_numpy(np.array(getattr(ref, f.name)))
        for f in dataclasses.fields(ProjectedSplats)})
    return ref, port


@pytest.mark.parametrize("kind", ["plain", "shrink", "cap"])
def test_bin_splats_matches_jax(kind):
    cloud, cfg = _scene(kind)
    ref_splats, splats = _projected(cloud, cfg)
    ref = jax_bin(ref_splats, W, H, JaxConfig(**dataclasses.asdict(cfg)))
    got = bin_splats(splats, W, H, cfg)

    start = np.asarray(ref.tile_start)
    count = np.asarray(ref.tile_count)
    np.testing.assert_array_equal(got.tile_start.numpy(), start)
    np.testing.assert_array_equal(got.tile_count.numpy(), count)
    assert int(got.num_pairs) == int(ref.num_pairs)
    assert int(got.overflow) == int(ref.overflow)
    if kind == "plain":
        assert int(ref.overflow) == 0
    else:
        assert int(ref.overflow) > 0     # the shrink / the cap really ran

    ref_gidx = np.asarray(ref.sorted_gidx)
    gidx = got.sorted_gidx.numpy()
    for t in np.nonzero(count)[0]:
        s, c = start[t], count[t]
        np.testing.assert_array_equal(gidx[s:s + c], ref_gidx[s:s + c],
                                      err_msg=f"tile {t}")

    # the full slot permutation: a permutation of every slot id whose
    # kept live pairs sit in the reference's sorted order
    n_slots = splats.depth.shape[0] * cfg.max_dup
    slots = got.sorted_slot.numpy()
    np.testing.assert_array_equal(np.sort(slots), np.arange(n_slots))
    kept = int(ref.num_pairs)
    np.testing.assert_array_equal(slots[:kept],
                                  np.asarray(ref.sorted_slot)[:kept])


def test_float_to_sortable_uint_matches_jax():
    vals = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 0.2, 7.25,
                     1e30, np.inf], np.float32)
    ref = np.asarray(jax_sortable(jnp.asarray(vals))).astype(np.int64)
    got = float_to_sortable_uint(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.all(np.diff(got[vals != 0]) > 0)


@pytest.mark.parametrize("device,cfg,kernels", [
    ("cuda", BASE, True),
    ("cuda", BASE.replace(depth_bits=19, tile_cull=True), True),
    ("cuda", BASE.replace(tier_split=16), True),     # d_a = max_dup: one tier
    ("cuda", BASE.replace(depth_bits=19, tier_split=2), False),
    ("cpu", BASE, False),
    ("cpu", BASE.replace(depth_bits=19, tier_split=2), False),
])
def test_binning_route(device, cfg, kernels):
    assert takes_kernels(torch.device(device), cfg) is kernels


def test_cuda_splats_take_the_kernels(monkeypatch):
    """A CUDA-resident single-tier call goes to `bin_splats_cuda` (stubbed:
    this machine has no card); a tiered one would not."""
    monkeypatch.setattr(bin_cuda, "bin_splats_cuda", lambda *a: "kernels")
    on_card = types.SimpleNamespace(
        depth=types.SimpleNamespace(device=torch.device("cuda")))
    assert bin_splats(on_card, W, H, BASE) == "kernels"


@pytest.mark.parametrize("cfg", [BASE, BASE.replace(depth_bits=19,
                                                    tier_split=2)])
def test_cpu_splats_take_the_plain_path(cfg):
    cloud, _ = _scene("plain")
    _, splats = _projected(cloud, cfg)
    before = build.launch_counts()["bin"]
    got = bin_splats(splats, W, H, cfg)
    want = bin_splats_plain(splats, W, H, cfg)
    assert build.launch_counts()["bin"] == before
    for f in ("sorted_gidx", "sorted_slot", "tile_start", "tile_count",
              "num_pairs", "overflow"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
