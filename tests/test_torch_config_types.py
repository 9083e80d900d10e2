"""Port config, containers and camera loading vs the JAX package: field
names, defaults, the packed and tiered modes, numpy converters,
cameras.json, and that the port never imports jax."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gaussian_splatting_web_tpu.config import RenderConfig as JaxConfig
from gaussian_splatting_web_tpu.core import camera as jax_camera
from gaussian_splatting_web_tpu.core.types import CameraParams as JaxCamera
from gaussian_splatting_web_tpu.core.types import GaussianCloud as JaxCloud
from gaussian_splatting_web_tpu.core.types import numpy_cloud
from gaussian_splatting_web_tpu.io.cameras import load_cameras_json as jax_load
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core import camera as port_camera
from gaussian_splatting_web_tpu_torch.core.types import (
    CameraParams,
    GaussianCloud,
)
from gaussian_splatting_web_tpu_torch.io.cameras import load_cameras_json
from tests.conftest import make_random_cloud

torch.set_num_threads(2)

EXACT_MODE = {"depth_bits": 0, "tier_split": 0, "pack_fields": False,
              "pack_mean16": False, "pack_grads": False}


def test_config_field_names_equal():
    port = [f.name for f in dataclasses.fields(RenderConfig)]
    ref = [f.name for f in dataclasses.fields(JaxConfig)]
    assert sorted(port) == sorted(ref)
    # the port config converts 1:1 into the reference config
    assert JaxConfig(**dataclasses.asdict(RenderConfig())) == JaxConfig(
        **EXACT_MODE)


def test_config_defaults_equal_except_exact_mode():
    port, ref = RenderConfig(), JaxConfig()
    for f in dataclasses.fields(JaxConfig):
        want = EXACT_MODE.get(f.name, getattr(ref, f.name))
        assert getattr(port, f.name) == want, f.name
    assert port.grid_size(1920, 1080) == ref.grid_size(1920, 1080) == (120, 68)


@pytest.mark.parametrize("field,value", [
    ("depth_bits", 19), ("tier_split", 2), ("pack_fields", True),
    ("tile_cull", True),
])
def test_config_rejects_unported_modes(field, value):
    """The four modes this test used to see refused (ROADMAP §1 item 12)
    are ported: each builds, converts 1:1 to the JAX config, and no
    refusal naming the ROADMAP is left in the port."""
    port = RenderConfig(**{field: value})
    assert JaxConfig(**dataclasses.asdict(port)) == JaxConfig(
        **{**EXACT_MODE, field: value})
    import inspect

    from gaussian_splatting_web_tpu_torch import config as port_config
    assert "NotImplementedError" not in inspect.getsource(port_config)


@pytest.mark.parametrize("field,value", [
    ("depth_bits", 19), ("tier_split", 2), ("pack_fields", True),
    ("tile_cull", True), ("pack_mean16", True), ("pack_grads", True),
])
def test_config_accepts_item_12_modes(field, value):
    """Every item-12 field converts 1:1 both ways, alone and together with
    the others at the JAX package's defaults (its shipped packed
    configuration), for either binning."""
    port = RenderConfig(**{field: value})
    assert JaxConfig(**dataclasses.asdict(port)) == JaxConfig(
        **{**EXACT_MODE, field: value})
    for binning in ("dup", "anchor"):
        ref = JaxConfig(binning=binning, **{field: value})
        assert JaxConfig(**dataclasses.asdict(
            RenderConfig(**dataclasses.asdict(ref)))) == ref


@pytest.mark.parametrize("field,value", [
    ("debug_selected", 0), ("dtype", "bfloat16"), ("dtype", "bf16"),
])
def test_config_accepts_item_13_modes(field, value):
    """The splat highlight and bf16 scene storage are ported (ROADMAP §1
    item 13) and convert to the JAX config; an unknown dtype is refused."""
    port = RenderConfig(**{field: value})
    assert JaxConfig(**dataclasses.asdict(port)) == JaxConfig(
        **EXACT_MODE, **{field: value})
    with pytest.raises(ValueError, match="storage dtype"):
        RenderConfig(dtype="float16")


@pytest.mark.parametrize("max_per_tile", [256, 300, 1024])
def test_config_anchor_binning_converts_to_jax(max_per_tile):
    """binning='anchor' is ported (kernels C and D); its caps follow
    max_per_tile as in the JAX package, and the packed anchor mode stays
    refused."""
    from gaussian_splatting_web_tpu.ops.pallas.anchor import _c_max
    from gaussian_splatting_web_tpu.ops.pallas.raster import k_cap_for
    from gaussian_splatting_web_tpu_torch.ops import anchor

    port = RenderConfig(binning="anchor", max_per_tile=max_per_tile)
    ref = JaxConfig(**dataclasses.asdict(port))
    assert ref == JaxConfig(binning="anchor", max_per_tile=max_per_tile,
                            **EXACT_MODE)
    assert anchor.c_max(port) == _c_max(ref)
    assert anchor.k_cap(port) == k_cap_for(ref)

    # the packed anchor mode: the config builds; a frame of 65,536 tiles
    # or more is refused by its binning, as the JAX package's is, and
    # bin_and_composite falls back to the dup binning there, as the JAX
    # package's select_fused_rasterizer does
    from gaussian_splatting_web_tpu.ops.rasterize import (
        select_fused_rasterizer,
    )
    from gaussian_splatting_web_tpu_torch.ops.projection import (
        ProjectedSplats,
    )
    from gaussian_splatting_web_tpu_torch.ops.rasterize import uses_anchor

    packed = port.replace(pack_fields=True)
    jpacked = JaxConfig(**dataclasses.asdict(packed))
    for w, h in ((1920, 1080), (4096, 4096), (4112, 4096)):
        want = select_fused_rasterizer(w, h, jpacked).__name__
        assert uses_anchor(w, h, packed) == (want == "rasterize_anchor")
        assert uses_anchor(w, h, port)       # the exact mode: any size
    assert not uses_anchor(4096, 4096, packed)
    empty = ProjectedSplats(
        mean2d=torch.zeros(1, 2), conic=torch.ones(1, 3),
        depth=torch.ones(1), radius=torch.zeros(1), rgb=torch.zeros(1, 3),
        opacity=torch.ones(1), valid=torch.zeros(1, dtype=torch.bool))
    with pytest.raises(ValueError, match="16 bits"):
        anchor.bin_splats_anchor(empty, 4096, 4096, packed)
    assert int(anchor.bin_splats_anchor(empty, 4096, 4096,
                                        port).num_pairs) == 0
    # and past the packed order key's int32 limit the config is refused
    with pytest.raises(ValueError, match="order keys"):
        RenderConfig(binning="anchor", pack_fields=True, max_per_tile=7936)
    RenderConfig(binning="anchor", pack_fields=True, max_per_tile=7935)


def test_cloud_numpy_roundtrip():
    ref = numpy_cloud(make_random_cloud(17, seed=3, sh_degree=2))
    port = GaussianCloud.from_numpy(ref)
    assert port.num_gaussians == 17 and port.sh_degree == 2
    assert port.xyz.dtype == torch.float32 and port.device.type == "cpu"
    back = JaxCloud(**port.to_numpy())
    for f in ("xyz", "log_scale", "quat", "opacity_logit", "sh"):
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(ref, f)))
    lo, hi = port.bbox()
    np.testing.assert_array_equal(lo.numpy(), ref.xyz.min(0))
    np.testing.assert_array_equal(hi.numpy(), ref.xyz.max(0))


def test_camera_numpy_roundtrip_and_camera_math():
    kw = dict(eye=(0.3, -1.0, -6.0), center=(0.1, 0.0, 0.2), up=(0, 1, 0))
    ref = jax_camera.default_camera(72, 40, **kw)
    port = port_camera.default_camera(72, 40, **kw)
    for f in ("view", "proj", "cam_pos", "focal", "tan_half_fov",
              "scale_modifier"):
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    back = JaxCamera(**CameraParams.from_numpy(ref).to_numpy())
    np.testing.assert_array_equal(np.asarray(back.view), np.asarray(ref.view))


def test_port_imports_no_jax():
    """Importing every port module leaves jax (and PIL) out of sys.modules:
    the machine with the card has neither."""
    mods = [
        "gaussian_splatting_web_tpu_torch",
        "gaussian_splatting_web_tpu_torch.bench_lib",
        "gaussian_splatting_web_tpu_torch.cli",
        "gaussian_splatting_web_tpu_torch.core.camera",
        "gaussian_splatting_web_tpu_torch.io",
        "gaussian_splatting_web_tpu_torch.io.dataset",
        "gaussian_splatting_web_tpu_torch.io.ply",
        "gaussian_splatting_web_tpu_torch.ops.anchor",
        "gaussian_splatting_web_tpu_torch.ops.cuda.anchor",
        "gaussian_splatting_web_tpu_torch.models.gaussian_model",
        "gaussian_splatting_web_tpu_torch._native_build",
        "gaussian_splatting_web_tpu_torch.native.plyio",
        "gaussian_splatting_web_tpu_torch.ops",
        "gaussian_splatting_web_tpu_torch.ops.composite",
        "gaussian_splatting_web_tpu_torch.ops.cuda.build",
        "gaussian_splatting_web_tpu_torch.ops.cuda.raster",
        "gaussian_splatting_web_tpu_torch.ops.projection",
        "gaussian_splatting_web_tpu_torch.ops.rasterize",
        "gaussian_splatting_web_tpu_torch.ops.sh",
        "gaussian_splatting_web_tpu_torch.ops.sort",
        "gaussian_splatting_web_tpu_torch.parallel",
        "gaussian_splatting_web_tpu_torch.parallel.dryrun",
        "gaussian_splatting_web_tpu_torch.parallel.gaussian_sharded",
        "gaussian_splatting_web_tpu_torch.parallel.multihost",
        "gaussian_splatting_web_tpu_torch.train.checkpoint",
        "gaussian_splatting_web_tpu_torch.train.densify",
        "gaussian_splatting_web_tpu_torch.train.loss",
        "gaussian_splatting_web_tpu_torch.train.train_loop",
        "gaussian_splatting_web_tpu_torch.train.trainer",
        "gaussian_splatting_web_tpu_torch.utils",
        "gaussian_splatting_web_tpu_torch.utils.image",
        "gaussian_splatting_web_tpu_torch.utils.metrics",
        "gaussian_splatting_web_tpu_torch.utils.tracing",
        "gaussian_splatting_web_tpu_torch.viewer.orbit",
        "gaussian_splatting_web_tpu_torch.viewer.server",
    ]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'PIL',\n"
            "                                    'gaussian_splatting_web_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cameras_json_matches_jax():
    raw = json.dumps([
        {"id": 0, "img_name": "a", "width": 80, "height": 60,
         "position": [0.5, -0.2, -4.0], "fx": 70.0, "fy": 72.0,
         "rotation": [[1, 0, 0], [0, 1, 0], [0, 0, 1]]},
        {"id": 1, "img_name": "b", "width": 64, "height": 48,
         "position": [1.0, 0.3, -3.0], "fx": 50.0, "fy": 50.0,
         "rotation": [[0.8, 0, 0.6], [0, 1, 0], [-0.6, 0, 0.8]]},
    ])
    for size in (None, (72, 40)):
        ref = jax_load(raw, target_size=size)
        got = load_cameras_json(raw, target_size=size)
        assert [g[1:] for g in got] == [r[1:] for r in ref]
        for (c, _, _), (r, _, _) in zip(got, ref):
            for f in ("view", "proj", "cam_pos", "focal", "tan_half_fov"):
                np.testing.assert_array_equal(getattr(c, f).numpy(),
                                              np.asarray(getattr(r, f)))
