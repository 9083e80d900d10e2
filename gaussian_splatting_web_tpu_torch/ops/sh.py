"""Spherical-harmonics color evaluation (degrees 0-3), the port of the JAX
package's `ops/sh.py` (the reference's `compute_color_from_sh`,
simple_render.ts:5-67). The degree is taken from the coefficient shape."""

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
