"""The footprint cull of kernels A-D (`csrc/footprint.cuh`) through its
plain mirror `ops/cuda/raster.py::footprint_blocks`, and the heavy-first
tile orders (A, B and D by count, C by the union its merge reads).

The cull may skip a warp's 8x4 pixel block for a pair only when no pixel
of the block reaches the 1/255 cutoff. Each case puts seeded or
hand-picked pairs into one 16x16 tile and asserts, through `cull_stats`,
that no pixel whose power in the plain twin (`ops/rasterize.py::_segments`)
passes the cutoff lies in a block the mirror culls. Torch only, no JAX;
seconds on the CPU.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gaussian_splatting_web_tpu_torch.bench_lib import make_adversarial_scene
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core.camera import default_camera
from gaussian_splatting_web_tpu_torch.ops import anchor
from gaussian_splatting_web_tpu_torch.ops.cuda import anchor as anchor_cuda
from gaussian_splatting_web_tpu_torch.ops.cuda import raster as raster_cuda
from gaussian_splatting_web_tpu_torch.ops.projection import project_gaussians
from gaussian_splatting_web_tpu_torch.ops.rasterize import (
    FIELD_ROW,
    GRAD_ROW,
    pack_splat_fields,
)
from gaussian_splatting_web_tpu_torch.ops.sort import TileBins, bin_splats

CFG = RenderConfig(max_per_tile=1 << 16)
LOG_CUT = math.log(CFG.alpha_cutoff)
ALL = 0xFF


def _conics(rng, n, log_sigma, log_ratio):
    """Conics (inverse covariances) of ellipses with major standard
    deviation exp(log_sigma) px, axis ratio exp(log_ratio), random angle."""
    s1 = np.exp(rng.uniform(*log_sigma, n))
    s2 = s1 * np.exp(-rng.uniform(*log_ratio, n))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    i1, i2 = 1 / s1 ** 2, 1 / s2 ** 2
    return c * c * i1 + s * s * i2, c * s * (i1 - i2), s * s * i1 + c * c * i2


def _pairs(case, seed=0):
    """(mx, my, ca, cb, cc, op) float64 arrays for one case."""
    rng = np.random.default_rng(seed)
    n = 3000
    if case == "random":
        mx, my = rng.uniform(-20, 36, (2, n))
        conic = _conics(rng, n, (-1.5, 3.5), (0, 2))
        op = rng.uniform(1 / 255, 1, n)
    elif case == "needles":
        mx, my = rng.uniform(-30, 46, (2, n))
        conic = _conics(rng, n, (0, 5), (3, 7))
        op = rng.uniform(0.05, 1, n)
    elif case == "far_centres":
        mx, my = rng.choice([-1, 1], (2, n)) * np.exp(rng.uniform(3, 9, (2, n)))
        conic = _conics(rng, n, (3, 10), (0, 3))
        op = rng.uniform(0.5, 1, n)
    elif case == "op_at_cutoff":
        # centres on, and a hair off, pixel centres; op at the cutoff and
        # one float32 ulp either side of it
        mx = rng.integers(-2, 18, n) + rng.choice([0, 1e-4, -1e-4, 0.5], n)
        my = rng.integers(-2, 18, n) + rng.choice([0, 1e-4, -1e-4, 0.5], n)
        conic = _conics(rng, n, (-2, 2), (0, 1))
        cut = np.float32(1 / 255)
        op = rng.choice([cut, np.nextafter(cut, np.float32(1)),
                         np.nextafter(cut, np.float32(0))], n)
    elif case == "det_to_zero":
        # cb^2 a hair under, at and over ca cc: det → 0 and below
        mx, my = rng.uniform(-4, 20, (2, n))
        ca = np.exp(rng.uniform(-6, 3, n))
        cc = np.exp(rng.uniform(-6, 3, n))
        gap = rng.choice([1e-2, 1e-4, 1e-7, 0.0, -1e-7, -1e-3], n)
        cb = rng.choice([-1, 1], n) * np.sqrt(ca * cc * (1 - gap))
        conic = (ca, cb, cc)
        op = rng.uniform(0.1, 1, n)
    elif case == "sub_pixel":
        mx = rng.integers(0, 16, n) + rng.uniform(-0.05, 0.05, n)
        my = rng.integers(0, 16, n) + rng.uniform(-0.05, 0.05, n)
        conic = _conics(rng, n, (-5, -1), (0, 2))
        op = rng.uniform(0.01, 1, n)
    elif case == "non_finite":
        mx, my = rng.uniform(-4, 20, (2, n))
        conic = list(_conics(rng, n, (-1, 3), (0, 2)))
        bad = rng.choice([np.inf, -np.inf, np.nan, 1e30, -1e30], n)
        which = rng.integers(0, 5, n)
        for k, arr in enumerate([mx, my, *conic]):
            arr[which == k] = bad[which == k]
        op = rng.uniform(0.1, 1, n)
    else:
        raise ValueError(case)
    return mx, my, *conic, op


def _one_tile(mx, my, ca, cb, cc, op):
    """The pairs as one 16x16 tile's segment: fields [n, 12] (tile origin
    0, so the means are tile-local) and bins holding them in order."""
    n = mx.shape[0]
    f = np.zeros((n, FIELD_ROW), np.float32)
    f[:, 0], f[:, 1], f[:, 2], f[:, 3], f[:, 4], f[:, 8] = (
        mx, my, ca, cb, cc, op)
    f[:, 5:8] = 0.5
    bins = TileBins(
        sorted_gidx=torch.arange(n, dtype=torch.int32),
        sorted_slot=torch.arange(n, dtype=torch.int64),
        tile_start=torch.zeros(1, dtype=torch.int32),
        tile_count=torch.full((1,), n, dtype=torch.int32),
        num_pairs=torch.tensor(n), overflow=torch.tensor(0))
    return torch.from_numpy(f), bins


def _mirror(f):
    log_op = torch.log(torch.clamp(f[:, 8], min=1e-30))
    return raster_cuda.footprint_blocks(f[:, 0], f[:, 1], f[:, 2], f[:, 3],
                                        f[:, 4], log_op, LOG_CUT)


CASES = ["random", "needles", "far_centres", "op_at_cutoff", "det_to_zero",
         "sub_pixel", "non_finite"]


@pytest.mark.parametrize("case", CASES)
def test_cull_skips_no_passing_pixel(case):
    fields, bins = _one_tile(*_pairs(case))
    stats = raster_cuda.cull_stats(fields, bins, 16, 16, CFG)
    assert stats["missed"] == 0, stats
    assert stats["steps"] == fields.shape[0] * 256
    mask = _mirror(fields)
    if case in ("random", "needles", "sub_pixel", "far_centres"):
        assert stats["culled"] > 0, stats      # the cull does cull
    if case == "non_finite":
        finite = torch.isfinite(fields[:, :5]).all(1)
        assert bool((mask[~finite] == ALL).all()) and bool((~finite).any())
    if case == "det_to_zero":
        f = fields.double()
        det = f[:, 2] * f[:, 4] - f[:, 3] ** 2
        assert bool((mask[det <= 0] == ALL).all())


CSRC = Path(raster_cuda.__file__).parents[2] / "csrc"


def _constexpr(header, name):
    """The value of `constexpr <type> <name> = <value>;` in csrc/<header>."""
    text = (CSRC / header).read_text()
    found = re.findall(rf"constexpr\s+\w+\s+{name}\s*=\s*([-+.\w]+?)f?;",
                       text)
    assert len(found) == 1, (header, name, found)
    return float(found[0])


@pytest.mark.parametrize("header,name,mirror", [
    ("footprint.cuh", "kBlockW", raster_cuda.BLOCK[0]),
    ("footprint.cuh", "kBlockH", raster_cuda.BLOCK[1]),
    ("footprint.cuh", "kCullRel", raster_cuda.CULL_REL),
    ("footprint.cuh", "kCullWiden", raster_cuda.CULL_WIDEN),
    ("footprint.cuh", "kCullPad", raster_cuda.CULL_PAD),
    ("tile_order.cuh", "kOrderClasses", raster_cuda.ORDER_CLASSES),
    ("tile_walk.cuh", "kRow", FIELD_ROW),
    ("tile_walk.cuh", "kGrad", GRAD_ROW),
    ("tile_walk.cuh", "kFwdBatch", anchor_cuda.FWD_BATCH),
    ("anchor_fwd.cu", "kChunk", anchor.KCL),
])
def test_mirror_constants_match_headers(header, name, mirror):
    """The port's Python mirrors copy the kernels' constants; an edit to a
    kernel source must reach the copy."""
    assert _constexpr(header, name) == mirror


def test_cull_edges():
    """Hand-picked pairs: a positive-definite pair whose opacity is below
    the cutoff culls every block; det <= 0, a non-positive ca and any
    non-finite term keep every block; a small round splat keeps only the
    block it sits in."""
    rows = torch.tensor([
        # mx,  my,   ca,   cb,  cc,   op
        [8.0, 8.0, 1.0, 0.0, 1.0, 0.003],      # op below 1/255
        [8.0, 8.0, 1.0, 1.0, 1.0, 1.0],        # det = 0
        [8.0, 8.0, 1.0, 2.0, 1.0, 1.0],        # det < 0
        [8.0, 8.0, -1.0, 0.0, -1.0, 1.0],      # negative definite
        [8.0, 8.0, float("nan"), 0.0, 1.0, 1.0],
        [float("inf"), 8.0, 1.0, 0.0, 1.0, 1.0],
        [2.0, 1.0, 4.0, 0.0, 4.0, 1.0],        # sigma 0.5 px at (2, 1)
        [12.0, 14.0, 4.0, 0.0, 4.0, 1.0],      # at (12, 14)
    ], dtype=torch.float32)
    f = torch.zeros((rows.shape[0], FIELD_ROW))
    f[:, [0, 1, 2, 3, 4, 8]] = rows
    mask = _mirror(f).tolist()
    assert mask[0] == 0
    assert mask[1:6] == [ALL] * 5
    assert mask[6] == 1 << 0              # block (0, 0)
    assert mask[7] == 1 << 7              # block column 1, row 3


def test_cull_on_adversarial_scene():
    """The adversarial scene of the kernel checks, binned: the cull skips
    no passing step on any of its 24 tiles, and splats reach max_dup."""
    w, h = 96, 64
    cloud = make_adversarial_scene(device="cpu")
    camera = default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    cfg = RenderConfig()
    splats = project_gaussians(cloud, camera, w, h, cfg)
    bins = bin_splats(splats, w, h, cfg)
    assert int(bins.overflow) > 0
    stats = raster_cuda.cull_stats(pack_splat_fields(splats), bins, w, h, cfg)
    assert stats["missed"] == 0 and 0 < stats["culled"] < stats["steps"]


def test_cull_on_adversarial_scene_mean16():
    """The same under the JAX package's packed modes: with pack_mean16 the
    kernels form the footprint mask from the quantized tile-local mean
    (up to 1/64 px off the f32 one), so the mirror, which takes the
    twin's quantized mean, still culls no passing step."""
    w, h = 96, 64
    cloud = make_adversarial_scene(device="cpu")
    camera = default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    cfg = RenderConfig(depth_bits=19, tier_split=2, pack_fields=True,
                       pack_mean16=True, pack_grads=True)
    splats = project_gaussians(cloud, camera, w, h, cfg)
    bins = bin_splats(splats, w, h, cfg)
    assert int(bins.overflow) > 0
    stats = raster_cuda.cull_stats(pack_splat_fields(splats, cfg), bins, w,
                                   h, cfg)
    assert stats["missed"] == 0 and 0 < stats["culled"] < stats["steps"]


def test_tile_order_is_heavy_first_permutation():
    cfg = RenderConfig(max_per_tile=64)
    w, h = 96, 64
    cloud = make_adversarial_scene(device="cpu")
    camera = default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    bins = bin_splats(project_gaussians(cloud, camera, w, h, cfg), w, h, cfg)
    order = raster_cuda.tile_order(bins, cfg)
    t = cfg.num_tiles(w, h)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(t))
    capped = torch.clamp(bins.tile_count, max=cfg.max_per_tile)[order.long()]
    assert bool((capped[:-1] >= capped[1:]).all())
    assert int(bins.tile_count.max()) > cfg.max_per_tile   # the cap binds


def test_anchor_tile_order_is_heavy_first_permutation():
    """Kernel C's schedule twin: a permutation of the tiles in descending
    union weight (the positions each tile's merge reads), classes binned
    once the cap passes the class count; on the adversarial scene."""
    w, h = 96, 64
    cloud = make_adversarial_scene(device="cpu")
    camera = default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    for cfg in (RenderConfig(binning="anchor", max_per_tile=64),
                RenderConfig(binning="anchor")):
        gx, gy = cfg.grid_size(w, h)
        abins = anchor.bin_splats_anchor(
            project_gaussians(cloud, camera, w, h, cfg), w, h, cfg)
        order = anchor_cuda.tile_order(abins, gx, gy, cfg)
        assert order.dtype == torch.int32
        assert sorted(order.tolist()) == list(range(gx * gy))
        weight, cap = anchor_cuda.schedule_weight(abins, gx, gy, cfg)
        cls = raster_cuda.order_class(weight, cap)
        assert bool((cls[order.long()][:-1] >= cls[order.long()][1:]).all())
        assert int(weight.max()) > 0
    assert cap >= raster_cuda.ORDER_CLASSES     # the default caps bin them
