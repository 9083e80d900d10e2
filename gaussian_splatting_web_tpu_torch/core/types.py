"""Scene and camera containers of the port: dataclasses of torch tensors.

The field layout is the JAX package's (`gaussian_splatting_web_tpu/core/
types.py`): structure-of-arrays, parameters in raw pre-activation form
(log-scale, opacity logit). `from_numpy` takes the JAX package's arrays as
`numpy_cloud` gives them (any object with the five attributes), so one
scene drives both packages; `to_numpy` gives them back as keyword
arguments of the JAX constructors, and `numpy_cloud` is the same under
the JAX package's name.
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

    def with_storage_dtype(self, dtype: str) -> "GaussianCloud":
        """The `RenderConfig.dtype` storage policy (JAX `core/types.py:
        73-101`): 'bfloat16' stores the log-scales, quaternions, opacity
        logits and SH in bf16 and keeps xyz in f32 (a bf16 mantissa would
        move centres by whole pixels); projection decodes every field to
        f32 at use. 'float32' returns the cloud itself. The casts are
        differentiable."""
        if dtype in ("float32", "f32"):
            return self
        if dtype not in ("bfloat16", "bf16"):
            raise ValueError(f"unsupported storage dtype {dtype!r}")
        bf = torch.bfloat16
        return GaussianCloud(xyz=self.xyz,
                             log_scale=self.log_scale.to(bf),
                             quat=self.quat.to(bf),
                             opacity_logit=self.opacity_logit.to(bf),
                             sh=self.sh.to(bf))

    def astype(self, dtype) -> "GaussianCloud":
        """Every field cast to `dtype`, positions too (JAX `core/types.py:
        64-71`); `with_storage_dtype` is the policy that keeps xyz f32."""
        return GaussianCloud(**{f: getattr(self, f).to(dtype)
                                for f in _CLOUD_FIELDS})

    def bbox(self):
        """(min, max) scene bounding box (ref: src/ply.ts:276-285)."""
        return self.xyz.amin(dim=0), self.xyz.amax(dim=0)

    def reindex(self, order) -> "GaussianCloud":
        """Every per-gaussian row reordered by `order` (an index array or
        tensor). Rendering sorts by depth per frame, so any permutation
        renders the same image."""
        order = torch.as_tensor(order, device=self.device)
        return GaussianCloud(**{f: getattr(self, f)[order]
                                for f in _CLOUD_FIELDS})

    def spatial_sort(self) -> "GaussianCloud":
        """The cloud in Morton order (one host-side sort, then the rows
        reordered on the cloud's device)."""
        return self.reindex(morton_order(self.xyz.detach().cpu().numpy()))


def morton_order(xyz: np.ndarray) -> np.ndarray:
    """Stable argsort of the 30-bit Morton (Z-order) codes of the positions
    quantized to 10 bits per axis over their bounding box."""
    p = np.nan_to_num(np.asarray(xyz, dtype=np.float64))
    lo, hi = p.min(axis=0), p.max(axis=0)
    q = ((p - lo) / np.maximum(hi - lo, 1e-12) * 1023.0).astype(np.uint64)

    def spread(v):  # interleave 10 bits with two zero bits each
        v &= np.uint64(0x3FF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable")


def numpy_cloud(cloud: GaussianCloud) -> dict:
    """Device → host copy of every field, as keyword arguments of the JAX
    package's GaussianCloud (`GaussianCloud.to_numpy`)."""
    return cloud.to_numpy()


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

    @property
    def view_proj(self) -> torch.Tensor:
        return self.proj @ self.view


def stack_cameras(cams) -> CameraParams:
    """A list of CameraParams stacked field by field on a leading axis."""
    return CameraParams(**{f: torch.stack([getattr(c, f) for c in cams])
                           for f in _CAMERA_FIELDS})
