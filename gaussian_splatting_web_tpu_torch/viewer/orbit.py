"""Orbit camera controller as a pure-function state machine.

Re-implements the reference's interactive camera (src/camera.ts:55-240 Camera
orbit ops + :243-461 InteractiveCamera) without DOM state: every interaction
is `new_state = f(state, delta)`, and `to_camera` projects the state into the
CameraParams the renderer consumes. The web viewer and any notebook UI drive
these functions; this is the whole behavioral surface of the reference's
mouse/touch/keyboard controls (rotate / pan / zoom / inertia).

Semantics reproduced:
  * rotate (camera.ts:184-234): yaw about world-up by -dx, pitch about the
    camera-right axis by -dy, with the pole-flip guard (same hemisphere x
    sign, |Δy| < 0.2).
  * translate/pan (camera.ts:147-164): pan in the camera basis scaled by
    distance/0.785, moving eye and center together (dx, dy negated on entry).
  * zoom (camera.ts:165-181): radius += wheel·0.001 clamped at ≥ 0.2, eye
    moved along the center→eye ray.
  * update + inertia (camera.ts:112-125): after release, the eye keeps
    drifting along its last direction by 0.05/step while inertia decays by
    0.05 per frame — and isDirty stays true while inertia > 0
    (camera.ts:440-442).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from ..core import camera as cam
from ..core.types import CameraParams

WORLD_UP = np.array([0.0, 1.0, 0.0])


@dataclasses.dataclass(frozen=True)
class OrbitState:
    eye: Tuple[float, float, float] = (0.0, -5.0, 3.0)
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    radius: float = 3.0
    previous_eye: Tuple[float, float, float] = (0.0, -5.0, 3.0)
    inertia: float = 0.0
    sensitivity: float = 0.1  # the reference's slider value / 1000 (camera.ts:74-76)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)  # rolled by u/o keys

    def replace(self, **kw) -> "OrbitState":
        return dataclasses.replace(self, **kw)


def _rot_about(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = math.cos(angle), math.sin(angle)
    C = 1 - c
    return np.array([
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
    ])


def rotate(state: OrbitState, dx: float, dy: float) -> OrbitState:
    """Orbit the eye around the center (camera.ts:184-234)."""
    if dx == 0 and dy == 0:
        return state
    two_pi = 2 * math.pi
    dx = dx * two_pi * state.sensitivity
    dy = dy * two_pi * state.sensitivity

    eye = np.asarray(state.eye, dtype=np.float64)
    center = np.asarray(state.center, dtype=np.float64)
    c2e = eye - center
    c2e = c2e / np.linalg.norm(c2e)
    axe_z = c2e.copy()

    c2e = _rot_about(WORLD_UP, -dx) @ c2e

    axe_x = np.cross(WORLD_UP, axe_z)
    n = np.linalg.norm(axe_x)
    if n > 1e-12:
        axe_x = axe_x / n
        rotated = _rot_about(axe_x, -dy) @ c2e
        # pole-flip guard (camera.ts:218-223)
        if (np.sign(rotated[0]) == np.sign(c2e[0])
                and abs(rotated[1] - c2e[1]) < 0.2):
            c2e = rotated

    new_eye = center + c2e * state.radius
    return state.replace(eye=tuple(new_eye))


def translate(state: OrbitState, dx: float, dy: float) -> OrbitState:
    """Pan eye and center together in the camera basis (camera.ts:147-164)."""
    dx, dy = -dx, -dy
    eye = np.asarray(state.eye, dtype=np.float64)
    center = np.asarray(state.center, dtype=np.float64)
    fz = eye - center
    length = np.linalg.norm(fz) / 0.785  # 45 degrees (camera.ts:153)
    fz = fz / max(np.linalg.norm(fz), 1e-12)
    fx = np.cross(WORLD_UP, fz)
    fy = np.cross(fz, fx)
    fx /= max(np.linalg.norm(fx), 1e-12)
    fy /= max(np.linalg.norm(fy), 1e-12)
    pan = (fx * (-dx) + fy * dy) * length
    return state.replace(eye=tuple(eye + pan), center=tuple(center + pan))


def zoom(state: OrbitState, delta: float) -> OrbitState:
    """Dolly along the view ray (camera.ts:165-181)."""
    radius = max(state.radius + delta * 0.001, 0.2)
    eye = np.asarray(state.eye, dtype=np.float64)
    center = np.asarray(state.center, dtype=np.float64)
    dir = eye - center
    dir = dir / max(np.linalg.norm(dir), 1e-12)
    return state.replace(radius=radius, eye=tuple(center + dir * radius))


def roll(state: OrbitState, dz: float) -> OrbitState:
    """Roll the camera-up vector about the view axis.

    The reference's u/o keys feed a dRZ delta (camera.ts:406-414) into
    rotate(x, y, z) — whose body never reads z (camera.ts:184-234), making
    them silent no-ops. We implement the evidently intended roll: rotate the
    up vector about the eye→center axis by the same 2π·sensitivity scaling
    rotate applies to x/y."""
    if dz == 0:
        return state
    dz = dz * 2 * math.pi * state.sensitivity
    eye = np.asarray(state.eye, dtype=np.float64)
    center = np.asarray(state.center, dtype=np.float64)
    axis = center - eye
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return state
    up = _rot_about(axis / n, dz) @ np.asarray(state.up, dtype=np.float64)
    up /= max(np.linalg.norm(up), 1e-12)
    return state.replace(up=tuple(up))


def set_sensitivity(state: OrbitState, value: float) -> OrbitState:
    """Rotate-speed slider (camera.ts:73-76: slider value / 1000)."""
    return state.replace(sensitivity=min(max(float(value), 1e-3), 10.0))


def release(state: OrbitState) -> OrbitState:
    """Mouse-up: arm inertia (camera.ts mouseup handler :356-363)."""
    return state.replace(inertia=1.0, previous_eye=state.eye)


def update(state: OrbitState) -> OrbitState:
    """Per-frame inertia step (camera.ts:112-125)."""
    if state.inertia <= 0:
        return state
    eye = np.asarray(state.eye, dtype=np.float64)
    prev = np.asarray(state.previous_eye, dtype=np.float64)
    d = eye - prev
    n = np.linalg.norm(d)
    if n > 1e-12:
        eye = eye + (d / n) * 0.05
    return state.replace(eye=tuple(eye), inertia=state.inertia - 0.05)


def is_dirty(state: OrbitState) -> bool:
    return state.inertia > 0


def to_camera(
    state: OrbitState,
    width: int,
    height: int,
    fov_y: float = cam.DEFAULT_FOV,
    znear: float = 0.03,
    zfar: float = 1000.0,
) -> CameraParams:
    """Project orbit state into renderer camera params (INRIA-canonical)."""
    return cam.default_camera(
        width, height, eye=state.eye, center=state.center,
        fov_y=fov_y, znear=znear, zfar=zfar, up=state.up,
    )
