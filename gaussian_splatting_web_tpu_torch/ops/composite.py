"""Post-process pass (ref: src/post_process_render.ts:63-76), the port of
the JAX package's `ops/composite.py`: boost a' = saturate(a·1.5), then
a' = a'^4 below the 0.99 knee."""

from __future__ import annotations

import torch

from ..config import RenderConfig


def post_process(
    rgb: torch.Tensor,
    alpha: torch.Tensor,
    config: RenderConfig = RenderConfig(),
) -> torch.Tensor:
    """Apply the reference's alpha shaping to premultiplied rgb [H, W, 3]
    and alpha [H, W]; returns [H, W, 4] rgba."""
    a = torch.clamp(alpha * config.post_alpha_boost, 0.0, 1.0)
    a = torch.where(a < config.post_alpha_knee, a ** config.post_alpha_pow, a)
    return torch.cat([rgb, a[..., None]], dim=-1)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """[0,1] float image → uint8."""
    return torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.uint8)
