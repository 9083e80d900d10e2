"""Spherical-harmonics color evaluation (degrees 0-3), the port of the JAX
package's `ops/sh.py` (the reference's `compute_color_from_sh`,
simple_render.ts:5-67). The degree is taken from the coefficient shape.
`sh_basis` and `sh_basis_grad` are the basis and its derivative as kernels
P fwd and P bwd (`csrc/project.cu`) form them, for the backward's plain
twin."""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def eval_sh(sh: torch.Tensor, xyz: torch.Tensor, cam_pos: torch.Tensor) -> torch.Tensor:
    """sh [N, K, 3], xyz [N, 3], cam_pos [3] → rgb [N, 3], offset by +0.5
    and clamped at 0 (simple_render.ts:62-65)."""
    k = sh.shape[-2]

    dir = xyz - cam_pos
    dir = dir / torch.clamp(torch.linalg.vector_norm(dir, dim=-1, keepdim=True),
                            min=1e-12)
    x, y, z = dir[..., 0:1], dir[..., 1:2], dir[..., 2:3]

    result = SH_C0 * sh[..., 0, :]

    if k > 1:  # degree 1 (simple_render.ts:35)
        result = result + SH_C1 * (
            -y * sh[..., 1, :] + z * sh[..., 2, :] - x * sh[..., 3, :]
        )
    if k > 4:  # degree 2 (simple_render.ts:45-50)
        xx, yy, zz = x * x, y * y, z * z
        xy, xz, yz = x * y, x * z, y * z
        result = result + (
            SH_C2[0] * xy * sh[..., 4, :]
            + SH_C2[1] * yz * sh[..., 5, :]
            + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
            + SH_C2[3] * xz * sh[..., 7, :]
            + SH_C2[4] * (xx - yy) * sh[..., 8, :]
        )
    if k > 9:  # degree 3 (simple_render.ts:53-60)
        result = result + (
            SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
            + SH_C3[1] * xy * z * sh[..., 10, :]
            + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
            + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12, :]
            + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
            + SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
            + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :]
        )

    return torch.clamp(result + 0.5, min=0.0)  # simple_render.ts:62-65


def sh_basis(dirs: torch.Tensor, k: int) -> torch.Tensor:
    """The first k of the 16 real SH basis functions (with their constants)
    at the unit directions dirs [N, 3] → [N, k]."""
    x, y, z = dirs.unbind(-1)
    basis = [torch.full_like(x, SH_C0)]
    if k > 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if k > 4:
        xx, yy, zz = x * x, y * y, z * z
        basis += [SH_C2[0] * (x * y), SH_C2[1] * (y * z),
                  SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * (x * z),
                  SH_C2[4] * (xx - yy)]
    if k > 9:
        basis += [SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * (x * y) * z,
                  SH_C3[2] * y * (4.0 * zz - xx - yy),
                  SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  SH_C3[4] * x * (4.0 * zz - xx - yy),
                  SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3.0 * yy)]
    return torch.stack(basis, -1)


def sh_basis_grad(dirs: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """sum_k e[:, k] · d basis_k / d dir at dirs [N, 3] for weights e [N, k]
    → [N, 3]."""
    k = e.shape[-1]
    x, y, z = dirs.unbind(-1)
    gx, gy, gz = (torch.zeros_like(x) for _ in range(3))
    if k > 1:
        gx = gx - SH_C1 * e[:, 3]
        gy = gy - SH_C1 * e[:, 1]
        gz = gz + SH_C1 * e[:, 2]
    if k > 4:
        c = SH_C2
        gx = gx + (c[0] * y * e[:, 4] - 2.0 * c[2] * x * e[:, 6]
                   + c[3] * z * e[:, 7] + 2.0 * c[4] * x * e[:, 8])
        gy = gy + (c[0] * x * e[:, 4] + c[1] * z * e[:, 5]
                   - 2.0 * c[2] * y * e[:, 6] - 2.0 * c[4] * y * e[:, 8])
        gz = gz + (c[1] * y * e[:, 5] + 4.0 * c[2] * z * e[:, 6]
                   + c[3] * x * e[:, 7])
    if k > 9:
        c = SH_C3
        xx, yy, zz = x * x, y * y, z * z
        gx = gx + (c[0] * 6.0 * x * y * e[:, 9] + c[1] * y * z * e[:, 10]
                   - c[2] * 2.0 * x * y * e[:, 11]
                   - c[3] * 6.0 * x * z * e[:, 12]
                   + c[4] * (4.0 * zz - 3.0 * xx - yy) * e[:, 13]
                   + c[5] * 2.0 * x * z * e[:, 14]
                   + c[6] * (3.0 * xx - 3.0 * yy) * e[:, 15])
        gy = gy + (c[0] * (3.0 * xx - 3.0 * yy) * e[:, 9]
                   + c[1] * x * z * e[:, 10]
                   + c[2] * (4.0 * zz - xx - 3.0 * yy) * e[:, 11]
                   - c[3] * 6.0 * y * z * e[:, 12]
                   - c[4] * 2.0 * x * y * e[:, 13]
                   - c[5] * 2.0 * y * z * e[:, 14]
                   - c[6] * 6.0 * x * y * e[:, 15])
        gz = gz + (c[1] * x * y * e[:, 10] + c[2] * 8.0 * y * z * e[:, 11]
                   + c[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy) * e[:, 12]
                   + c[4] * 8.0 * x * z * e[:, 13]
                   + c[5] * (xx - yy) * e[:, 14])
    return torch.stack([gx, gy, gz], -1)
