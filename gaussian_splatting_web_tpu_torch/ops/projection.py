"""Per-gaussian geometry: covariance build and EWA projection to screen
space, the port of the JAX package's `ops/projection.py` line for line in
semantics (the reference's vertex stage, simple_render.ts:217-332).

Conventions: view is world→camera with +z forward (INRIA/COLMAP), proj the
INRIA projection (clip.w = view z), pixel coordinates by
ndc2pix(v, S) = ((v+1)·S − 1)/2. The Jacobian uses per-axis focals, the
conic is the standard Σ₂D⁻¹, and the footprint radius is the exact
opacity-aware cutoff level set (see the JAX module's notes).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import RenderConfig
from ..core.types import CameraParams, GaussianCloud
from .sh import eval_sh


@dataclasses.dataclass
class ProjectedSplats:
    """Screen-space splats, one entry per input gaussian (masked by `valid`).

    mean2d [N, 2] pixel-space center; conic [N, 3] upper triangle (A, B, C)
    of Σ₂D⁻¹; depth [N] view-space depth; radius [N] pixel radius (0 when
    culled); rgb [N, 3]; opacity [N]; valid [N] bool.
    """

    mean2d: torch.Tensor
    conic: torch.Tensor
    depth: torch.Tensor
    radius: torch.Tensor
    rgb: torch.Tensor
    opacity: torch.Tensor
    valid: torch.Tensor


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (x, y, z, w) → [..., 3, 3] rotation matrix; the eps sits
    inside the sqrt so a zero quaternion stays finite in value and grad."""
    q = q / torch.sqrt(torch.clamp(torch.sum(q * q, dim=-1, keepdim=True),
                                   min=1e-24))
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        dim=-2,
    )


def compute_cov3d(log_scale: torch.Tensor, quat: torch.Tensor,
                  scale_modifier: torch.Tensor) -> torch.Tensor:
    """Σ₃D = (R S)(R S)ᵀ as the packed upper triangle [..., 6]
    (ref compute_cov3d, simple_render.ts:127-162)."""
    scale = torch.exp(log_scale) * scale_modifier
    R = quat_to_rotmat(quat)
    M = R * scale[..., None, :]  # R @ diag(scale)
    sigma = M @ M.transpose(-1, -2)
    return torch.stack(
        [sigma[..., 0, 0], sigma[..., 0, 1], sigma[..., 0, 2],
         sigma[..., 1, 1], sigma[..., 1, 2], sigma[..., 2, 2]],
        dim=-1,
    )


def ndc2pix(v: torch.Tensor, size: float) -> torch.Tensor:
    """INRIA pixel-center convention."""
    return ((v + 1.0) * size - 1.0) * 0.5


def project_gaussians(
    cloud: GaussianCloud,
    camera: CameraParams,
    width: int,
    height: int,
    config: RenderConfig,
) -> ProjectedSplats:
    """Project every gaussian to screen space; camera and cloud must lie on
    the same device."""
    f32 = torch.float32
    xyz = cloud.xyz.to(f32)
    view = camera.view.to(f32)
    proj = camera.proj.to(f32)

    # --- view / clip transform ------------------------------------------
    t = xyz @ view[:3, :3].T + view[:3, 3]  # [N,3] camera space
    depth = t[..., 2]
    pv = proj @ view
    clip = xyz @ pv[:3, :3].T + pv[:3, 3]
    clip_w = xyz @ pv[3, :3] + pv[3, 3]
    # behind-camera cull (simple_render.ts:230-233)
    in_front = clip_w > 0.2
    safe_w = torch.where(in_front, clip_w, torch.ones_like(clip_w))
    ndc = clip[..., :2] / safe_w[..., None]
    mean2d = torch.stack(
        [ndc2pix(ndc[..., 0], width), ndc2pix(ndc[..., 1], height)], dim=-1
    )

    # --- 3D covariance ---------------------------------------------------
    cov3d = compute_cov3d(cloud.log_scale.to(f32), cloud.quat.to(f32),
                          camera.scale_modifier.to(f32))
    c00, c01, c02, c11, c12, c22 = cov3d.unbind(-1)

    # --- EWA: cov2d = J W Σ Wᵀ Jᵀ ---------------------------------------
    tz = torch.where(in_front, depth, torch.ones_like(depth))
    lim_x = config.fov_clamp * camera.tan_half_fov[0]  # simple_render.ts:265-271
    lim_y = config.fov_clamp * camera.tan_half_fov[1]
    tx = torch.clamp(t[..., 0] / tz, -lim_x, lim_x) * tz
    ty = torch.clamp(t[..., 1] / tz, -lim_y, lim_y) * tz

    fx = camera.focal[0]
    fy = camera.focal[1]
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    # J rows with per-axis focals: [fx/z, 0, -fx·x/z²], [0, fy/z, -fy·y/z²]
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    W = view[:3, :3]
    u0 = j00[..., None] * W[0] + j02[..., None] * W[2]   # U = J @ W
    u1 = j11[..., None] * W[1] + j12[..., None] * W[2]

    def quad(a, b):
        """aᵀ Σ₃D b for row vectors a, b with packed Σ."""
        return (
            a[..., 0] * (c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2])
            + a[..., 1] * (c01 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2])
            + a[..., 2] * (c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2])
        )

    # low-pass dilation (simple_render.ts:295-296, INRIA 0.3)
    a2d = quad(u0, u0) + config.lowpass
    b2d = quad(u0, u1)
    c2d = quad(u1, u1) + config.lowpass

    det = a2d * c2d - b2d * b2d
    det_ok = det > 0.0
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    inv_det = 1.0 / safe_det
    conic = torch.stack([c2d * inv_det, -b2d * inv_det, a2d * inv_det], dim=-1)

    # --- appearance ------------------------------------------------------
    rgb = eval_sh(cloud.sh.to(f32), xyz, camera.cam_pos.to(f32))
    opacity = torch.sigmoid(cloud.opacity_logit.to(f32))  # simple_render.ts:328

    # exact opacity-aware footprint radius: α < alpha_cutoff outside the
    # level set ½dᵀΣ⁻¹d = ln(opacity/cutoff), max extent √(2 λ₁ ln(..))
    mid = 0.5 * (a2d + c2d)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    if config.radius_sigma > 0:
        radius = torch.ceil(config.radius_sigma * torch.sqrt(lam1))
    else:
        log_ratio = torch.log(
            torch.clamp(opacity, min=config.alpha_cutoff) / config.alpha_cutoff
        )
        radius = torch.ceil(torch.sqrt(2.0 * lam1 * log_ratio))
    radius = torch.clamp(radius, max=config.max_radius_px)

    # --- visibility ------------------------------------------------------
    on_screen = (
        (mean2d[..., 0] + radius >= 0)
        & (mean2d[..., 0] - radius < width)
        & (mean2d[..., 1] + radius >= 0)
        & (mean2d[..., 1] - radius < height)
    )
    valid = in_front & det_ok & (radius > 0) & on_screen

    return ProjectedSplats(
        mean2d=mean2d,
        conic=conic,
        depth=depth,
        radius=torch.where(valid, radius, torch.zeros_like(radius)),
        rgb=rgb,
        opacity=opacity,
        valid=valid,
    )
