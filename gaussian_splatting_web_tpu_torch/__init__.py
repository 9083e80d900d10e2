"""gaussian_splatting_web_tpu_torch — the PyTorch/CUDA port of
gaussian_splatting_web_tpu for one NVIDIA H100.

The JAX package beside it is the reference; every module here mirrors the
module of the same path there and is tested against it. The port imports
torch and never jax. Plain tensor code is PyTorch; each TPU kernel becomes a
hand-written Hopper kernel under csrc/, built at first use (ops/cuda/),
with a plain PyTorch twin beside it that CPU tensors take.

  config.py   RenderConfig (same fields as the JAX package; exact mode)
  core/       GaussianCloud / CameraParams tensors, camera math
  io/         PLY read/write, cameras.json
  ops/        projection + SH, tile binning, compositor, post-process
    cuda/     kernel wrappers and the nvcc build
  csrc/       CUDA C++ kernels (sm_90a)
  viewer/     orbit state machine + web viewer
  utils/      PNG output
  cli.py      info / render / serve
"""

__version__ = "0.1.0"

from .config import RenderConfig
from .core.types import CameraParams, GaussianCloud

__all__ = ["RenderConfig", "GaussianCloud", "CameraParams", "__version__"]
