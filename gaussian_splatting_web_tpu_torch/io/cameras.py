"""INRIA `cameras.json` loader, the port of the JAX package's
`io/cameras.py` (ref: src/camera.ts:463-578). Pass a target (width,
height) to reproduce the reference's focal-to-canvas quirk, or omit it to
use each camera's stored resolution."""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

import numpy as np

from ..core import camera as cam
from ..core.types import CameraParams


def camera_from_json(
    raw: dict,
    target_size: Optional[Tuple[int, int]] = None,
    znear: float = 0.2,
    zfar: float = 100.0,
) -> Tuple[CameraParams, Tuple[int, int], str]:
    """One cameras.json entry → (camera, (width, height), img_name)."""
    if target_size is None:
        width, height = int(raw["width"]), int(raw["height"])
    else:
        width, height = target_size
    fov_x = cam.focal2fov(float(raw["fx"]), width)   # camera.ts:482
    fov_y = cam.focal2fov(float(raw["fy"]), height)  # camera.ts:483
    proj = cam.projection_inria(znear, zfar, fov_x, fov_y)
    view = cam.world_to_cam_from_rt(
        np.asarray(raw["rotation"], dtype=np.float64),
        np.asarray(raw["position"], dtype=np.float64),
    )
    camera = cam.make_camera(view, proj, width, height)
    return camera, (width, height), str(raw.get("img_name", raw.get("id", "")))


def load_cameras_json(
    path_or_str,
    target_size: Optional[Tuple[int, int]] = None,
    znear: float = 0.2,
    zfar: float = 100.0,
) -> List[Tuple[CameraParams, Tuple[int, int], str]]:
    """Load every camera of a cameras.json file or JSON string
    (ref camera.ts:539-550)."""
    if isinstance(path_or_str, str) and path_or_str.lstrip().startswith("["):
        data = json.loads(path_or_str)
    else:
        with open(path_or_str) as f:
            data = json.load(f)
    return [camera_from_json(raw, target_size, znear, zfar) for raw in data]
