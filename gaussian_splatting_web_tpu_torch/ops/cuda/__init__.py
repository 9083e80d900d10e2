"""Hand-written CUDA kernels: wrappers and the build at first use.

`runs_kernels` is the one choice between a kernel and its plain PyTorch
twin: every wrapper's Function, and binning (`ops/sort.py::takes_kernels`),
asks it. The modules here reach the kernels through `build.py`'s launcher
only.
"""

from __future__ import annotations

import torch


def runs_kernels(device: torch.device, what: str) -> bool:
    """True for a CUDA device (the kernels), False for the CPU (the plain
    twins); any other device has no `what` and raises ValueError."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {device}")
    return device.type == "cuda"
