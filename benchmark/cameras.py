"""Orbit cameras of the benchmark's scenes, frozen here so the yardstick
does not move with the program: a look-at from `eye` to the origin with a
vertical field of view `fov_y`, canonicalised from GL (-z forward, y up) to
COLMAP (+z forward, y down), and INRIA's projection matrix. View i of n
sits at angle 2*pi*i/n on a circle of `radius` at height `height`.

Each camera is a dict of float32 tensors: view [4, 4] world to camera,
proj [4, 4], cam_pos [3], focal [2] in pixels, tan_half_fov [2],
scale_modifier [] (always 1), the layout both the program's
`CameraParams` and the reference take.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GL_TO_COLMAP = np.diag([1.0, -1.0, -1.0, 1.0])


def look_at(eye, center, up) -> np.ndarray:
    """Right-handed look-at view matrix, -z forward (float64)."""
    eye, center, up = (np.asarray(v, dtype=np.float64)
                       for v in (eye, center, up))
    z = eye - center
    z /= np.linalg.norm(z)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = x, y, z
    view[:3, 3] = -view[:3, :3] @ eye
    return view


def projection(znear: float, zfar: float, fov_x: float,
               fov_y: float) -> np.ndarray:
    """INRIA's projection matrix (clip w = view z, depth in [0, 1])."""
    top = math.tan(fov_y / 2) * znear
    right = math.tan(fov_x / 2) * znear
    p = np.zeros((4, 4))
    p[0, 0] = znear / right
    p[1, 1] = znear / top
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    p[3, 2] = 1.0
    return p


def orbit_camera(i: int, n: int, width: int, height: int, radius: float,
                 height_above: float, fov_y_deg: float, znear: float,
                 zfar: float, device) -> dict:
    """View i of n around the origin (see the module docstring)."""
    a = 2 * math.pi * i / n
    eye = (radius * math.sin(a), height_above, -radius * math.cos(a))
    view = (GL_TO_COLMAP @ look_at(eye, (0, 0, 0), (0, 1, 0))).astype(
        np.float32)
    fov_y = math.radians(fov_y_deg)
    fov_x = 2 * math.atan(math.tan(fov_y / 2) * width / height)
    proj = projection(znear, zfar, fov_x, fov_y).astype(np.float32)
    tan_x, tan_y = 1.0 / abs(float(proj[0, 0])), 1.0 / abs(float(proj[1, 1]))
    r = view[:3, :3].astype(np.float64)
    cam_pos = (-r.T @ view[:3, 3].astype(np.float64)).astype(np.float32)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32),
                               device=device)

    return {"view": t(view), "proj": t(proj), "cam_pos": t(cam_pos),
            "focal": t([width / (2 * tan_x), height / (2 * tan_y)]),
            "tan_half_fov": t([tan_x, tan_y]),
            "scale_modifier": t(1.0)}


def scene_extent(cameras) -> float:
    """INRIA's camera extent: 1.1 times the largest distance of a camera
    centre from the centres' mean."""
    centers = torch.stack([c["cam_pos"] for c in cameras]).double()
    return float((centers - centers.mean(0)).norm(dim=1).max()) * 1.1
