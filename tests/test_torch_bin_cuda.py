"""Binning's CUDA path (`csrc/bin.cu`, `ops/cuda/bin.py`) on the card against
the PyTorch path `bin_splats_plain` run on the same CUDA tensors: every
field of `TileBins` equal bit for bit (sorted_gidx, the whole sorted_slot,
tile_start, tile_count, num_pairs, overflow, dtypes and shapes) in the
exact key, the packed key with its many ties, tile_cull, a gather-cap cut,
oversized footprints (the shrink and its defect), radius_sigma > 0, more
than 32 slots a Gaussian, invalid splats and the padded rows of a
Gaussian-sharded exchange (strided fields), N = 0, deliberately tied
depths, int64 slot ids and a scene of `mipnerf360`'s size; the launch
counter; one host sync a call; the tiered mode left to the PyTorch path.

Marked `gpu`: every test skips without a CUDA device. The file imports
neither jax nor tests/conftest.py, so it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_bin_cuda.py
"""

import warnings

import pytest
import torch

from gaussian_splatting_web_tpu_torch.bench_lib import make_scene
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core.camera import default_camera
from gaussian_splatting_web_tpu_torch.ops import sort
from gaussian_splatting_web_tpu_torch.ops.cuda import bin as bin_cuda
from gaussian_splatting_web_tpu_torch.ops.cuda import build
from gaussian_splatting_web_tpu_torch.ops.projection import (
    ProjectedSplats,
    project_gaussians,
)
from gaussian_splatting_web_tpu_torch.parallel.gaussian_sharded import (
    _pack_splat_rows,
    _unpack_splat_rows,
)

pytestmark = pytest.mark.gpu

FIELDS = ("sorted_gidx", "sorted_slot", "tile_start", "tile_count",
          "num_pairs", "overflow")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def projected(dev, n, w, h, cfg, seed=0, log_scale=(-6.0, -4.0), eye_z=-8.0):
    cloud = make_scene(n, seed=seed, sh_degree=0, log_scale_range=log_scale,
                       device=dev)
    camera = default_camera(w, h, eye=(0.3, -0.2, eye_z),
                            center=(0, 0, 0)).to(dev)
    with torch.no_grad():
        return project_gaussians(cloud, camera, w, h, cfg)


def check_same(splats, w, h, cfg):
    """Kernel path == PyTorch path on the same tensors, field for field;
    returns the bins."""
    before = build.launch_counts()["bin"]
    got = sort.bin_splats(splats, w, h, cfg)
    assert build.launch_counts()["bin"] == before + 1
    want = sort.bin_splats_plain(splats, w, h, cfg)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (f, a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(a, b), (f, int((a != b).sum()))
    assert got.tier_a_width == want.tier_a_width == cfg.max_dup
    assert got.comp_widths == () and got.comp_idx == ()
    return got


SCENES = {
    # name: (n, width, height, config, log-scale range)
    "exact": (200_000, 640, 480, RenderConfig(), (-6.0, -4.0)),
    "packed": (200_000, 640, 480, RenderConfig(depth_bits=19), (-6.0, -4.0)),
    "cull": (100_000, 640, 480, RenderConfig(tile_cull=True), (-4.0, -2.5)),
    "packed-cull": (100_000, 640, 480,
                    RenderConfig(depth_bits=19, tile_cull=True),
                    (-4.0, -2.5)),
    "cap": (100_000, 640, 480,
            RenderConfig(gather_cap_factor=0.2, gather_cap_floor=0),
            (-4.0, -2.5)),
    "shrink": (20_000, 320, 200, RenderConfig(max_dup=4), (-3.0, -1.0)),
    "sigma": (50_000, 320, 200, RenderConfig(radius_sigma=3.0),
              (-4.0, -2.5)),
    "dup40": (20_000, 320, 200, RenderConfig(max_dup=40, tile_cull=True),
              (-3.0, -1.0)),
    "ragged": (1_000, 72, 40, RenderConfig(), (-4.0, -2.0)),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_kernel_bins_equal_plain(device, name):
    n, w, h, cfg, log_scale = SCENES[name]
    bins = check_same(projected(device, n, w, h, cfg, log_scale=log_scale),
                      w, h, cfg)
    assert int(bins.num_pairs) > 0
    if name in ("cap", "shrink"):
        assert int(bins.overflow) > 0        # the cut / the shrink ran


def test_mipnerf360_size(device):
    cfg = RenderConfig()
    check_same(projected(device, 2_960_000, 1237, 822, cfg), 1237, 822, cfg)


def test_invalid_and_padded_rows(device):
    """Invalid splats, then the zero padding rows of the exchange, read
    through the strided columns of one [R, 16] row array."""
    cfg = RenderConfig(tile_cull=True)
    splats = projected(device, 30_000, 320, 200, cfg, log_scale=(-4.0, -2.5))
    rows = _pack_splat_rows(splats)
    rows[::3, 11] = 0.0                                   # invalid
    rows = torch.cat([rows, rows.new_zeros((5_000, 16))])   # padding
    check_same(_unpack_splat_rows(rows), 320, 200, cfg)


def test_tied_depths(device):
    cfg = RenderConfig()
    s = projected(device, 50_000, 320, 200, cfg, log_scale=(-4.0, -2.5))
    tied = ProjectedSplats(**{**vars(s), "depth": torch.round(s.depth * 2)})
    bins = check_same(tied, 320, 200, cfg)
    assert int(bins.num_pairs) > torch.unique(tied.depth).numel()


def test_no_splats(device):
    cfg = RenderConfig()
    s = projected(device, 10, 64, 48, cfg)
    empty = ProjectedSplats(**{k: v[:0] for k, v in vars(s).items()})
    bins = check_same(empty, 64, 48, cfg)
    assert int(bins.num_pairs) == 0 and bins.sorted_slot.numel() == 0


def test_int64_slot_ids(device, monkeypatch):
    """Frames of 2^31 slots or more sort int64 slot ids: forced here."""
    monkeypatch.setattr(bin_cuda, "INT32_SLOTS", 0)
    for cfg in (RenderConfig(), RenderConfig(depth_bits=19)):
        check_same(projected(device, 50_000, 320, 200, cfg), 320, 200, cfg)


def test_one_host_sync(device):
    cfg = RenderConfig()
    splats = projected(device, 100_000, 640, 480, cfg)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            sort.bin_splats(splats, 640, 480, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # (set_sync_debug_mode's own warning, that the mode is a prototype,
    # is not a sync)
    syncs = [f"{c.filename}:{c.lineno}: {c.message}" for c in caught
             if "called a synchronizing" in str(c.message)]
    assert len(syncs) == 1, syncs


def test_tiered_mode_takes_plain_path(device):
    cfg = RenderConfig(depth_bits=19, tier_split=2)
    splats = projected(device, 20_000, 320, 200, cfg, log_scale=(-4.0, -2.5))
    before = build.launch_counts()["bin"]
    got = sort.bin_splats(splats, 320, 200, cfg)
    assert build.launch_counts()["bin"] == before
    want = sort.bin_splats_plain(splats, 320, 200, cfg)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
