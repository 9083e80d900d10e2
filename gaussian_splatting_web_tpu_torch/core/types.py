"""Scene and camera containers of the port: dataclasses of torch tensors.

The field layout is the JAX package's (`gaussian_splatting_web_tpu/core/
types.py`): structure-of-arrays, parameters in raw pre-activation form
(log-scale, opacity logit). `from_numpy` takes the JAX package's arrays as
`numpy_cloud` gives them (any object with the five attributes), so one
scene drives both packages; `to_numpy` gives them back as keyword
arguments of the JAX constructors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_CLOUD_FIELDS = ("xyz", "log_scale", "quat", "opacity_logit", "sh")
_CAMERA_FIELDS = ("view", "proj", "cam_pos", "focal", "tan_half_fov",
                  "scale_modifier")


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


@dataclasses.dataclass
class GaussianCloud:
    """xyz [N, 3], log_scale [N, 3], quat [N, 4] (x, y, z, w),
    opacity_logit [N], sh [N, K, 3] with K in {1, 4, 9, 16}."""

    xyz: torch.Tensor
    log_scale: torch.Tensor
    quat: torch.Tensor
    opacity_logit: torch.Tensor
    sh: torch.Tensor

    @classmethod
    def from_numpy(cls, src, device="cpu") -> "GaussianCloud":
        return cls(**{f: _tensor(getattr(src, f), device)
                      for f in _CLOUD_FIELDS})

    def to_numpy(self) -> dict:
        return {f: getattr(self, f).detach().cpu().numpy()
                for f in _CLOUD_FIELDS}

    def to(self, device) -> "GaussianCloud":
        return GaussianCloud(**{f: getattr(self, f).to(device)
                                for f in _CLOUD_FIELDS})

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def num_gaussians(self) -> int:
        return self.xyz.shape[0]

    @property
    def sh_degree(self) -> int:
        return {1: 0, 4: 1, 9: 2, 16: 3}[self.sh.shape[1]]

    def bbox(self):
        """(min, max) scene bounding box (ref: src/ply.ts:276-285)."""
        return self.xyz.amin(dim=0), self.xyz.amax(dim=0)


@dataclasses.dataclass
class CameraParams:
    """view [4, 4] world→camera (+z forward), proj [4, 4] INRIA projection,
    cam_pos [3], focal [2] pixels, tan_half_fov [2], scale_modifier []."""

    view: torch.Tensor
    proj: torch.Tensor
    cam_pos: torch.Tensor
    focal: torch.Tensor
    tan_half_fov: torch.Tensor
    scale_modifier: torch.Tensor

    @classmethod
    def from_numpy(cls, src, device="cpu") -> "CameraParams":
        return cls(**{f: _tensor(getattr(src, f), device)
                      for f in _CAMERA_FIELDS})

    def to_numpy(self) -> dict:
        return {f: getattr(self, f).detach().cpu().numpy()
                for f in _CAMERA_FIELDS}

    def to(self, device) -> "CameraParams":
        return CameraParams(**{f: getattr(self, f).to(device)
                               for f in _CAMERA_FIELDS})
