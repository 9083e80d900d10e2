"""Per-gaussian geometry: covariance build and EWA projection to screen
space, the port of the JAX package's `ops/projection.py` line for line in
semantics (the reference's vertex stage, simple_render.ts:217-332).

Conventions: view is world→camera with +z forward (INRIA/COLMAP), proj the
INRIA projection (clip.w = view z), pixel coordinates by
ndc2pix(v, S) = ((v+1)·S − 1)/2. The Jacobian uses per-axis focals, the
conic is the standard Σ₂D⁻¹, and the footprint radius is the exact
opacity-aware cutoff level set (see the JAX module's notes).

`project_gaussians` runs through `ops/cuda/project.py::ProjectFn`: kernels
P fwd and P bwd (`csrc/project.cu`) for CUDA tensors, the plain twins
`project_gaussians_plain` (the forward in PyTorch ops) and
`project_backward_plain` (P bwd's hand-derived chain rule, line for line)
for CPU tensors. `pack_camera` is the camera as both kernels read it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import RenderConfig
from ..core.types import CameraParams, GaussianCloud
from ..utils import tracing
from .sh import eval_sh, sh_basis, sh_basis_grad

# the packed camera (`pack_camera`, csrc/project.cu)
CAMERA_FLOATS = 40


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
    return unit_quat_to_rotmat(q)


def unit_quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """The rotation matrix [..., 3, 3] of a quaternion already normalised."""
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


def pack_camera(camera: CameraParams,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The camera as kernels P fwd and P bwd read it, [40] on the camera's
    device, built with device ops (no value reaches the host): view [4, 4]
    and proj @ view [4, 4] row-major, cam_pos [3], focal [2],
    tan_half_fov [2], scale_modifier."""
    view = camera.view.to(dtype)
    return torch.cat([view.reshape(16),
                      (camera.proj.to(dtype) @ view).reshape(16),
                      camera.cam_pos.to(dtype).reshape(3),
                      camera.focal.to(dtype).reshape(2),
                      camera.tan_half_fov.to(dtype).reshape(2),
                      camera.scale_modifier.to(dtype).reshape(1)])


@tracing.spanned("projection")
def project_gaussians(
    cloud: GaussianCloud,
    camera: CameraParams,
    width: int,
    height: int,
    config: RenderConfig,
) -> ProjectedSplats:
    """Project every gaussian to screen space in float32 (every storage
    dtype is cast to it), differentiable in the cloud's parameters (not in
    the camera's: a camera tensor that requires grad raises); camera and
    cloud must lie on the same device. Kernels P fwd / P bwd for CUDA
    tensors, the plain twins for CPU tensors."""
    from .cuda.project import ProjectFn

    for f in dataclasses.fields(camera):
        if getattr(camera, f.name).requires_grad:
            raise ValueError(f"camera.{f.name} requires grad: the "
                             "projection gives no gradient of the camera")
    f32 = torch.float32
    return ProjectedSplats(*ProjectFn.apply(
        cloud.xyz.to(f32), cloud.log_scale.to(f32), cloud.quat.to(f32),
        cloud.opacity_logit.to(f32), cloud.sh.to(f32), camera, width,
        height, config))


def project_gaussians_plain(
    cloud: GaussianCloud,
    camera: CameraParams,
    width: int,
    height: int,
    config: RenderConfig,
) -> ProjectedSplats:
    """The plain twin of kernel P fwd: every gaussian to screen space, in
    PyTorch ops (float32, or float64 for a float64 cloud, so the tests can
    hold the backward twin and the kernels against its autograd in
    float64); camera and cloud must lie on the same device."""
    f32 = (torch.float64 if cloud.xyz.dtype == torch.float64
           else torch.float32)
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


def project_backward_plain(xyz, log_scale, quat, opacity_logit, sh, cam,
                           width: int, height: int, config: RenderConfig,
                           d_mean2d=None, d_conic=None, d_depth=None,
                           d_rgb=None, d_opacity=None):
    """The plain twin of kernel P bwd: the gradients of the projection's
    inputs (xyz [N, 3], log_scale [N, 3], quat [N, 4], opacity_logit [N],
    sh [N, K, 3], the packed camera `cam`) from those of its outputs (None:
    no gradient arrives there) → (d_xyz, d_log_scale, d_quat,
    d_opacity_logit, d_sh). It recomputes the forward's intermediates and
    applies the kernel's chain rule line for line: gradient reaches only
    the taken branch of each `torch.where` (the cull, det > 0), passes each
    clamp on its closed interval, and none flows through radius or
    valid. Autograd of `project_gaussians_plain` gives the same gradients;
    this twin is kept as the CPU mirror of P bwd's formulas, so the tests
    check the kernel's chain rule without a card."""
    n = xyz.shape[0]

    def grad(d, *shape):
        return xyz.new_zeros((n, *shape)) if d is None else d

    gm, gc, gd = grad(d_mean2d, 2), grad(d_conic, 3), grad(d_depth)
    grgb, gop = grad(d_rgb, 3), grad(d_opacity)
    V, PV = cam[0:16].reshape(4, 4), cam[16:32].reshape(4, 4)
    W = V[:3, :3]
    fx, fy = cam[35], cam[36]
    one = torch.ones_like(opacity_logit)

    # --- the forward's intermediates --------------------------------------
    t = xyz @ W.T + V[:3, 3]
    clip = xyz @ PV[:2, :3].T + PV[:2, 3]
    clip_w = xyz @ PV[3, :3] + PV[3, 3]
    in_front = clip_w > 0.2
    safe_w = torch.where(in_front, clip_w, one)
    ndc = clip / safe_w[:, None]
    s = torch.exp(log_scale) * cam[39]
    q2 = torch.sum(quat * quat, dim=-1, keepdim=True)
    qnorm = torch.sqrt(torch.clamp(q2, min=1e-24))
    qn = quat / qnorm
    R = unit_quat_to_rotmat(qn)
    M = R * s[:, None, :]
    cov = M @ M.transpose(-1, -2)
    tz = torch.where(in_front, t[:, 2], one)
    lim = config.fov_clamp * cam[37:39]
    r = t[:, :2] / tz[:, None]
    inside = (r >= -lim) & (r <= lim)
    cl = torch.minimum(torch.maximum(r, -lim), lim)
    txy = cl * tz[:, None]
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00, j11 = fx * inv_z, fy * inv_z
    j02 = -fx * txy[:, 0] * inv_z2
    j12 = -fy * txy[:, 1] * inv_z2
    u0 = j00[:, None] * W[0] + j02[:, None] * W[2]
    u1 = j11[:, None] * W[1] + j12[:, None] * W[2]
    su0 = (cov @ u0[..., None])[..., 0]
    su1 = (cov @ u1[..., None])[..., 0]
    a = torch.sum(u0 * su0, -1) + config.lowpass
    b = torch.sum(u0 * su1, -1)
    c = torch.sum(u1 * su1, -1) + config.lowpass
    det = a * c - b * b
    det_ok = det > 0.0
    inv_det = 1.0 / torch.where(det_ok, det, one)

    # --- appearance: opacity and SH colour --------------------------------
    op = torch.sigmoid(opacity_logit)
    d_opacity_logit = gop * (1.0 - op) * op
    v = xyz - cam[32:35]
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    nv = torch.clamp(norm, min=1e-12)
    dirs = v / nv
    B = sh_basis(dirs, sh.shape[1])                           # [N, K]
    res = torch.sum(B[..., None] * sh, dim=1)                 # [N, 3]
    d_res = torch.where(res + 0.5 >= 0.0, grgb, torch.zeros_like(grgb))
    d_sh = B[..., None] * d_res[:, None, :]
    d_dir = sh_basis_grad(dirs, torch.sum(sh * d_res[:, None, :], -1))
    dd = torch.where(norm >= 1e-12, torch.sum(d_dir * dirs, -1, keepdim=True),
                     torch.zeros_like(norm))
    d_xyz = (d_dir - dd * dirs) / nv

    # --- conic (c, -b, a) / det -------------------------------------------
    d_a = gc[:, 2] * inv_det
    d_b = -gc[:, 1] * inv_det
    d_c = gc[:, 0] * inv_det
    d_inv = gc[:, 0] * c - gc[:, 1] * b + gc[:, 2] * a
    d_det = torch.where(det_ok, -d_inv * inv_det * inv_det,
                        torch.zeros_like(det))
    d_a = d_a + d_det * c
    d_c = d_c + d_det * a
    d_b = d_b - 2.0 * b * d_det

    # --- a = u0 Σ u0, b = u0 Σ u1, c = u1 Σ u1 ----------------------------
    d_u0 = 2.0 * d_a[:, None] * su0 + d_b[:, None] * su1
    d_u1 = 2.0 * d_c[:, None] * su1 + d_b[:, None] * su0

    def outer(p, q):
        return p[:, :, None] * q[:, None, :]

    # G = dΣ + dΣᵀ of the packed upper triangle
    G = (2.0 * d_a[:, None, None] * outer(u0, u0)
         + d_b[:, None, None] * (outer(u0, u1) + outer(u1, u0))
         + 2.0 * d_c[:, None, None] * outer(u1, u1))

    # --- J W: u0 = j00 W0 + j02 W2, u1 = j11 W1 + j12 W2 ------------------
    d_j00, d_j02 = d_u0 @ W[0], d_u0 @ W[2]
    d_j11, d_j12 = d_u1 @ W[1], d_u1 @ W[2]
    d_inv_z = fx * d_j00 + fy * d_j11
    d_inv_z2 = -fx * txy[:, 0] * d_j02 - fy * txy[:, 1] * d_j12
    d_txy = torch.stack([-fx * inv_z2 * d_j02, -fy * inv_z2 * d_j12], -1)
    d_inv_z = d_inv_z + 2.0 * inv_z * d_inv_z2
    d_tz = -d_inv_z * inv_z * inv_z + torch.sum(d_txy * cl, -1)
    d_r = torch.where(inside, d_txy * tz[:, None], torch.zeros_like(d_txy))
    d_tz = d_tz - torch.sum(d_r * r, -1) / tz
    d_t = torch.cat([d_r / tz[:, None],
                     (torch.where(in_front, d_tz, torch.zeros_like(d_tz))
                      + gd)[:, None]], -1)

    # --- mean2d = ((clip / w + 1) size - 1) / 2 ---------------------------
    d_ndc = torch.stack([gm[:, 0] * 0.5 * width, gm[:, 1] * 0.5 * height],
                        -1)
    d_clip = d_ndc / safe_w[:, None]
    d_w = torch.where(in_front, -torch.sum(d_ndc * ndc, -1) / safe_w,
                      torch.zeros_like(safe_w))
    d_xyz = (d_xyz + d_t @ W + d_clip @ PV[:2, :3]
             + d_w[:, None] * PV[3, :3])

    # --- Σ = M Mᵀ, M = R diag(s), R from the unit quaternion --------------
    d_M = G @ M
    dR = d_M * s[:, None, :]
    d_log_scale = torch.sum(d_M * R, dim=1) * s
    x, y, z, w = qn.unbind(-1)

    def e(i, j):
        return dR[:, i, j]

    d_qn = torch.stack([
        2.0 * (y * (e(0, 1) + e(1, 0)) + z * (e(0, 2) + e(2, 0))
               + w * (e(2, 1) - e(1, 2))) - 4.0 * x * (e(1, 1) + e(2, 2)),
        2.0 * (x * (e(0, 1) + e(1, 0)) + w * (e(0, 2) - e(2, 0))
               + z * (e(1, 2) + e(2, 1))) - 4.0 * y * (e(0, 0) + e(2, 2)),
        2.0 * (w * (e(1, 0) - e(0, 1)) + x * (e(0, 2) + e(2, 0))
               + y * (e(1, 2) + e(2, 1))) - 4.0 * z * (e(0, 0) + e(1, 1)),
        2.0 * (z * (e(1, 0) - e(0, 1)) + y * (e(0, 2) - e(2, 0))
               + x * (e(2, 1) - e(1, 2))),
    ], -1)
    dq = torch.where(q2 >= 1e-24, torch.sum(d_qn * qn, -1, keepdim=True),
                     torch.zeros_like(q2))
    d_quat = (d_qn - dq * qn) / qnorm
    return d_xyz, d_log_scale, d_quat, d_opacity_logit, d_sh
