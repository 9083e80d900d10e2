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
reads them. Nothing here launches device work.

Spans are placed in the program: `render` (`ops/rasterize.py::render_impl`)
and `step` (`train/train_loop.py::make_densify_train_step`) at the top,
with `projection`, `binning`, `composite`, `loss`, `backward`, `adam` and
`densify_stats` under them, and `composite_bwd` and its `fold` in the
compositor's backward. Counters: `binning.live_pairs` and `binning.slots`
(`ops/sort.py::bin_splats`).
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


def counters() -> Dict[str, int]:
    """Every counter's value."""
    with _lock:
        return dict(_counts)
