"""Timing and throughput metrics of the port (the JAX package's
`utils/metrics.py`): `time_fn`, which times a callable on its device, and
the throughput in megapixels per second.

On a CUDA device `time_fn` brackets each call by `torch.cuda.synchronize()`
and a pair of CUDA events, so the wrappers' host syncs and the idle time
around them count: they are part of what a user waits for. On the CPU it
reads `time.perf_counter`.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
            device="cpu") -> dict:
    """Seconds per call of `fn(*args)` on `device` after `warmup` calls →
    {"median", "p90"}. On a CUDA device each call sits between
    `torch.cuda.synchronize()` and CUDA events; on the CPU the host clock
    brackets it."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return {"median": float(np.median(times)),
            "p90": float(np.percentile(times, 90))}


def throughput_mpixps(width: int, height: int, seconds: float) -> float:
    return width * height / seconds / 1e6
