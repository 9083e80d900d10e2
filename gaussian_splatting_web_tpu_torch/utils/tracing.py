"""Spans and counters at the port's layer boundaries.

    with tracing.span("composite"):
        ...
    tracing.count("binning.slots", slots)

    @tracing.spanned("loss")       # the whole function as one span
    def photometric_loss(...): ...

Tracing is on while a `torch.profiler` session records, and only then;
everywhere else `span` and `count` cost one flag check and do nothing
else: no `record_function`, no device work, no host sync.

When on, `span(name)` opens the profiler range "gs/<name>", so the span
and the device work launched inside it sit in the same trace on the
profiler's clock; a span's parent is the range open around it on its
thread in that trace. `count(name, value)` adds a host int to a counter;
counters add up over every profiled call of the process, and `counters()`
reads them. `count_device(name, tensor)` adds a device tensor to a counter
that stays on the device, with no host sync; `counters()` reads each such
counter once, when it is called. Nothing else here launches device work.

Spans are placed in the program: `render` (`ops/rasterize.py::render_impl`)
and `step` (`train/train_loop.py::make_densify_train_step`) at the top,
with `projection`, `binning`, `composite`, `loss`, `backward`, `adam` and
`densify_stats` under them, and `composite_bwd` and its `fold` in the
compositor's backward. The Gaussian-sharded step
(`parallel/gaussian_sharded.py`) opens `step` with `projection`,
`exchange`, `binning`, `composite`, `gather`, `loss`, `backward`, `return`
and `adam` under it. Counters: `binning.live_pairs` and `binning.slots`
(`ops/sort.py::bin_splats`); `exchange.slots` and `exchange.bytes_off`
(host ints) and `exchange.live_rows`, `exchange.band_max` and
`exchange.overflow` (on the device), in
`gaussian_sharded.py::banded_candidates_a2a`.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Dict

import torch
from torch.autograd import _profiler_enabled

PREFIX = "gs/"

_counts: Dict[str, int] = {}
_device_counts: Dict[str, torch.Tensor] = {}
_lock = threading.Lock()
_OFF = contextlib.nullcontext()


def on() -> bool:
    """Whether tracing is on: a profiler records."""
    return _profiler_enabled()


def span(name: str):
    """A context manager: the profiler range "gs/<name>" when tracing is
    on, else nothing."""
    return (torch.profiler.record_function(PREFIX + name) if on()
            else _OFF)


def spanned(name: str):
    """Decorator: every call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def count(name: str, value: int) -> None:
    """Add the host int `value` to the counter `name` when tracing is on."""
    if not on():
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + value


def count_device(name: str, value: torch.Tensor) -> None:
    """Add the device tensor `value` (a 0-d integer tensor) to the counter
    `name` when tracing is on. The sum stays on the value's device: no
    host sync until `counters()` reads it."""
    if not on():
        return
    value = value.detach().to(torch.int64)
    with _lock:
        acc = _device_counts.get(name)
        if acc is None:
            _device_counts[name] = value.clone()
        else:
            acc.add_(value)


def counters() -> Dict[str, int]:
    """Every counter's value; reads the device counters (one host sync
    each)."""
    with _lock:
        out = dict(_counts)
        for name, acc in _device_counts.items():
            out[name] = out.get(name, 0) + int(acc)
        return out
