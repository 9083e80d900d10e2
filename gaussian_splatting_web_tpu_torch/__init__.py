"""gaussian_splatting_web_tpu_torch — the PyTorch/CUDA port of
gaussian_splatting_web_tpu for one NVIDIA H100.

The JAX package beside it is the reference; every module here mirrors the
module of the same path there and is tested against it. The port imports
torch and never jax. Plain tensor code is PyTorch; each TPU kernel becomes a
hand-written Hopper kernel under csrc/, built at first use (ops/cuda/),
with a plain PyTorch twin beside it that CPU tensors take.

  config.py   RenderConfig (same fields as the JAX package; exact mode)
  core/       GaussianCloud / CameraParams tensors, camera math
  io/         PLY read/write, cameras.json, the training dataset
  native/     ctypes binding of the threaded PLY unpack (csrc/plyio.cpp)
  models/     GaussianModel (trainable parameters)
  ops/        projection + SH, tile binning (dup and anchor), compositor and
              its backward, post-process
    cuda/     kernel wrappers, the differentiable compositors, the builds
  csrc/       CUDA C++ kernels (sm_90a), six entries in four sources:
              raster_fwd.cu (A, and its tile-list entry E-A), raster_bwd.cu
              (B, E-B), anchor_fwd.cu (C), anchor_bwd.cu (D); the shared
              walks and schedule in *.cuh; plyio.cpp, host C++
  parallel/   tile and Gaussian sharding, multi-host start, the dry run
  train/      losses, per-group Adam, densification, train loop, checkpoints
  viewer/     orbit state machine + web viewer
  utils/      PNG encode/decode, image reading, timing metrics
  bench_lib.py  the bench, its scenes, work count and parity rules
  cli.py      info / render / serve / train / eval / bench
"""

__version__ = "0.1.0"

from .config import RenderConfig
from .core.types import CameraParams, GaussianCloud

__all__ = ["RenderConfig", "GaussianCloud", "CameraParams", "__version__"]
