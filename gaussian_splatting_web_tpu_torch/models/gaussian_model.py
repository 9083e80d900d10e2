"""The trainable Gaussian scene model, the port of the JAX package's
`models/gaussian_model.py`: six raw parameters (positions, log-scales,
quaternions, opacity logits, SH DC and the higher SH bands) as
`nn.Parameter`s, so the optimizer can give each its own learning rate and
progressive SH training can mask bands without re-partitioning arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.types import GaussianCloud

PARAMS = ("xyz", "log_scale", "quat", "opacity_logit", "sh_dc", "sh_rest")
_SH_COEFFS = {0: 1, 1: 4, 2: 9, 3: 16}


class GaussianModel(nn.Module):
    """xyz [N, 3], log_scale [N, 3], quat [N, 4] (x, y, z, w, unnormalised
    is fine), opacity_logit [N], sh_dc [N, 1, 3], sh_rest [N, K−1, 3]."""

    def __init__(self, xyz, log_scale, quat, opacity_logit, sh_dc, sh_rest):
        super().__init__()
        for name, value in zip(PARAMS, (xyz, log_scale, quat, opacity_logit,
                                        sh_dc, sh_rest)):
            if not isinstance(value, torch.Tensor):
                value = np.array(value, dtype=np.float32)   # a copy
            t = torch.as_tensor(value, dtype=torch.float32)
            setattr(self, name, nn.Parameter(t.detach().clone()))

    @property
    def num_gaussians(self) -> int:
        return self.xyz.shape[0]

    @property
    def max_sh_degree(self) -> int:
        return {1: 0, 4: 1, 9: 2, 16: 3}[1 + self.sh_rest.shape[1]]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def to_cloud(self, active_sh_degree: Optional[int] = None
                 ) -> GaussianCloud:
        """Assemble the renderer input (differentiable in the parameters).
        `active_sh_degree` zeroes the higher bands (progressive SH training,
        INRIA `oneupSHdegree`)."""
        sh = torch.cat([self.sh_dc, self.sh_rest], dim=1)
        if (active_sh_degree is not None
                and active_sh_degree < self.max_sh_degree):
            k_active = _SH_COEFFS[active_sh_degree]
            mask = torch.arange(sh.shape[1], device=sh.device) < k_active
            sh = sh * mask[None, :, None]
        return GaussianCloud(xyz=self.xyz, log_scale=self.log_scale,
                             quat=self.quat,
                             opacity_logit=self.opacity_logit, sh=sh)

    @classmethod
    def from_cloud(cls, cloud: GaussianCloud) -> "GaussianModel":
        sh = cloud.sh
        return cls(cloud.xyz, cloud.log_scale, cloud.quat,
                   cloud.opacity_logit, sh[:, :1], sh[:, 1:]).to(cloud.device)

    @classmethod
    def from_numpy(cls, src, device="cpu") -> "GaussianModel":
        """From any object with the six attributes as arrays, e.g. the JAX
        package's GaussianModel."""
        return cls(*(np.asarray(getattr(src, f), dtype=np.float32)
                     for f in PARAMS)).to(device)

    def to_numpy(self) -> dict:
        """The parameters as NumPy arrays, keyword arguments of the JAX
        package's GaussianModel."""
        return {f: getattr(self, f).detach().cpu().numpy() for f in PARAMS}

    @classmethod
    def from_points(
        cls,
        xyz: np.ndarray,
        rgb: Optional[np.ndarray] = None,
        sh_degree: int = 3,
        initial_opacity: float = 0.1,
    ) -> "GaussianModel":
        """Initialise from a point cloud (the INRIA from-SfM recipe, with
        the JAX package's NumPy draws): isotropic scales from the mean
        distance to a few nearest neighbours, identity rotations,
        inverse-sigmoid opacity, colours into the DC band. On the CPU."""
        xyz = np.asarray(xyz, dtype=np.float32)
        n = xyz.shape[0]
        k = _SH_COEFFS[sh_degree]
        if n > 1:
            cap = min(n, 2048)
            sub = xyz[np.random.default_rng(0).choice(n, cap, replace=False)]
            if n * cap < 4e7:
                d2 = ((xyz[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
                d2[d2 == 0] = np.inf
                dist = np.sqrt(np.clip(
                    np.partition(d2, 2, axis=1)[:, :3].mean(1), 1e-7, None))
            else:
                dist = np.full(n, 0.01, np.float32)
        else:
            dist = np.full(n, 0.1, np.float32)

        quat = np.zeros((n, 4), dtype=np.float32)
        quat[:, 3] = 1.0
        sh_dc = np.zeros((n, 1, 3), dtype=np.float32)
        if rgb is not None:
            # invert the SH DC mapping colour = C0·dc + 0.5
            sh_dc[:, 0] = ((np.asarray(rgb, np.float32) - 0.5)
                           / 0.28209479177387814)
        log_scale = np.repeat(
            np.log(np.asarray(dist, np.float32))[:, None], 3, axis=1)
        logit = np.float32(np.log(initial_opacity / (1 - initial_opacity)))
        return cls(xyz, log_scale, quat, np.full((n,), logit, np.float32),
                   sh_dc, np.zeros((n, k - 1, 3), np.float32))
