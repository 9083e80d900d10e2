"""Port config, containers and camera loading vs the JAX package: field
names, defaults, unported modes, numpy converters, cameras.json, and that
the port never imports jax."""

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
    ("binning", "anchor"), ("tile_cull", True), ("debug_selected", 0),
    ("dtype", "bfloat16"),
])
def test_config_rejects_unported_modes(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RenderConfig(**{field: value})


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
        "gaussian_splatting_web_tpu_torch.ops.composite",
        "gaussian_splatting_web_tpu_torch.ops.cuda.build",
        "gaussian_splatting_web_tpu_torch.ops.cuda.raster",
        "gaussian_splatting_web_tpu_torch.ops.projection",
        "gaussian_splatting_web_tpu_torch.ops.rasterize",
        "gaussian_splatting_web_tpu_torch.ops.sh",
        "gaussian_splatting_web_tpu_torch.ops.sort",
        "gaussian_splatting_web_tpu_torch.utils.image",
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
