"""Camera math (NumPy; small 4x4 host-side work), copied from the JAX
package's `core/camera.py` with the same conventions: INRIA projection
(+z forward, depth in [0, 1]), look-at view matrices canonicalized from
GL (-z forward) to COLMAP (+z forward), and the cameras.json loading
convention. `make_camera` returns the port's `CameraParams` on the CPU;
the renderer moves it to the scene's device.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from .types import CameraParams

DEFAULT_FOV = 1.04719755  # 60 degrees (camera.ts:4)


def projection_inria(znear: float, zfar: float, fov_x: float, fov_y: float) -> np.ndarray:
    """INRIA-convention projection matrix (ref camera.ts:19-42)."""
    tan_half_fov_y = math.tan(fov_y / 2)
    tan_half_fov_x = math.tan(fov_x / 2)
    top = tan_half_fov_y * znear
    right = tan_half_fov_x * znear

    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def look_at(eye: Sequence[float], center: Sequence[float], up: Sequence[float]) -> np.ndarray:
    """Right-handed look-at view matrix, -z forward (ref camera.ts:114)."""
    eye = np.asarray(eye, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)

    z = eye - center
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)

    view = np.eye(4, dtype=np.float64)
    view[0, :3] = x
    view[1, :3] = y
    view[2, :3] = z
    view[:3, 3] = -view[:3, :3] @ eye
    return view.astype(np.float32)


def focal2fov(focal: float, pixels: float) -> float:
    """ref camera.ts:463-465."""
    return 2 * math.atan(pixels / (2 * focal))


def world_to_cam_from_rt(R_c2w: np.ndarray, cam_center: Sequence[float]) -> np.ndarray:
    """World→camera matrix from a cameras.json entry (ref camera.ts:467-473):
    view(p) = Rᵀ (p - t)."""
    R_c2w = np.asarray(R_c2w, dtype=np.float64).reshape(3, 3)
    t = np.asarray(cam_center, dtype=np.float64)
    view = np.eye(4, dtype=np.float64)
    view[:3, :3] = R_c2w.T
    view[:3, 3] = -R_c2w.T @ t
    return view.astype(np.float32)


def camera_position_from_view(view: np.ndarray) -> np.ndarray:
    """Camera center in world space (ref camera.ts:135-138)."""
    R = view[:3, :3]
    t = view[:3, 3]
    return (-R.T @ t).astype(np.float32)


def make_camera(
    view: np.ndarray,
    proj: np.ndarray,
    width: int,
    height: int,
    focal_x: float | None = None,
    focal_y: float | None = None,
    scale_modifier: float = 1.0,
) -> CameraParams:
    """Assemble CameraParams. Focals default to what the projection implies
    (tan = 1 / P[0][0] etc., simple_render.ts:262-263)."""
    view = np.asarray(view, dtype=np.float32)
    proj = np.asarray(proj, dtype=np.float32)
    tan_x = 1.0 / abs(float(proj[0, 0]))
    tan_y = 1.0 / abs(float(proj[1, 1]))
    if focal_x is None:
        focal_x = width / (2 * tan_x)  # simple_render.ts:273
    if focal_y is None:
        focal_y = height / (2 * tan_y)
    return CameraParams(
        view=torch.from_numpy(view.copy()),
        proj=torch.from_numpy(proj.copy()),
        cam_pos=torch.from_numpy(camera_position_from_view(view)),
        focal=torch.tensor([focal_x, focal_y], dtype=torch.float32),
        tan_half_fov=torch.tensor([tan_x, tan_y], dtype=torch.float32),
        scale_modifier=torch.tensor(scale_modifier, dtype=torch.float32),
    )


GL_TO_COLMAP = np.diag(np.array([1.0, -1.0, -1.0, 1.0], dtype=np.float32))


def gl_to_colmap_view(view_gl: np.ndarray) -> np.ndarray:
    """-z-forward/y-up (GL) view matrix → +z-forward/y-down (COLMAP)."""
    return (GL_TO_COLMAP @ np.asarray(view_gl, dtype=np.float32)).astype(np.float32)


def default_camera(
    width: int,
    height: int,
    eye=(0, -5, 3),
    center=(0, 0, 0),
    fov_y: float = DEFAULT_FOV,
    znear: float = 0.03,
    zfar: float = 1000.0,
    up=(0, 1, 0),
) -> CameraParams:
    """The reference's default orbit camera (camera.ts:101-111), look-at
    from `eye` with a 60° perspective, canonicalized to INRIA."""
    aspect = width / height
    fov_x = 2 * math.atan(math.tan(fov_y / 2) * aspect)
    view = gl_to_colmap_view(look_at(eye, center, up))
    proj = projection_inria(znear, zfar, fov_x, fov_y)
    return make_camera(view, proj, width, height)
