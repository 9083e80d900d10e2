"""Spans around the program's layers, and the reduction of a
`torch.profiler` trace to what the per-layer metrics read.

Spans are the benchmark's own: in a traced run `Spans` replaces
module-level names that the program looks up at call time (for example
`ops/rasterize.py::project_gaussians`) by wrappers that open a
`record_function` range named "bench/<span>", and puts the originals back
afterwards. Nothing inside the program changes.

`reduce` reads the profiler's events (`kineto_results.events()`): host
ranges of the spans, the runtime calls that launched device work, and the
device's kernels, copies and sets. A device operation belongs to the span
whose host range holds the runtime call that launched it (matched by
correlation id), so work that the autograd thread launches during a
span's range counts there too. Spans never nest, apart from the window.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Tuple

import torch

PREFIX = "bench/"
WINDOW = PREFIX + "window"
OTHER = "other"


class Spans:
    """Wrap `module.attr` in a span for each (module, attr, span[, after])
    target; use as a context manager. With `after`, a span of that name
    opens when the call returns and lasts until the next wrapped call (the
    backward pass between the loss and the optimizer)."""

    def __init__(self, targets):
        self.targets = [tuple(t) + (None,) * (4 - len(t)) for t in targets]
        self.saved = []
        self.open_range = None

    def __enter__(self):
        for module, attr, span, after in self.targets:
            orig = getattr(module, attr)
            self.saved.append((module, attr, orig))
            setattr(module, attr, self._wrap(orig, span, after))
        return self

    def __exit__(self, *exc):
        self.close()
        for module, attr, orig in reversed(self.saved):
            setattr(module, attr, orig)
        self.saved.clear()

    def _wrap(self, fn, span, after):
        def wrapped(*args, **kwargs):
            self.close()
            with torch.profiler.record_function(PREFIX + span):
                out = fn(*args, **kwargs)
            if after is not None:
                self.open_range = torch.profiler.record_function(
                    PREFIX + after)
                self.open_range.__enter__()
            return out
        wrapped.__wrapped__ = fn
        return wrapped

    def close(self) -> None:
        if self.open_range is not None:
            rng, self.open_range = self.open_range, None
            rng.__exit__(None, None, None)


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    span_device_s: Dict[str, float]        # span → device seconds
    kernel_s: Dict[str, List[float]]       # kernel → durations in order
    device_ops: List[Tuple[str, float]]    # top names by total seconds
    idle_gaps: List[Tuple[str, float]]     # top host activities by idle s
    events: int


def _union(intervals) -> float:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def short(name: str, n: int = 96) -> str:
    name = name.replace("(anonymous namespace)::", "")
    return name if len(name) <= n else name[:n]


def reduce(prof, top: int = 10) -> Summary:
    """The summary of a profile whose window is the "bench/window" range."""
    spans, launches, ops, device = [], {}, {}, []
    window = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_device = e.device_type() != torch.autograd.DeviceType.CPU
        if e.is_user_annotation():
            if not on_device and name.startswith(PREFIX):
                rng = (e.start_ns(), e.start_ns() + e.duration_ns())
                if name == WINDOW:
                    window = rng
                else:
                    spans.append((rng[0], rng[1], name[len(PREFIX):]))
            continue
        if on_device:
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                           name, e.correlation_id(),
                           e.linked_correlation_id()))
        elif name.startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()
        else:
            ops[e.correlation_id()] = name
    if window is None:
        window = (min((d[0] for d in device), default=0),
                  max((d[1] for d in device), default=0))
    w0, w1 = window
    device = sorted(d for d in device if d[1] > w0 and d[0] < w1)
    spans.sort()
    starts = [s[0] for s in spans]

    def span_of(t):
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and t <= spans[i][1] else OTHER

    span_s = collections.Counter()
    kernel_s = collections.defaultdict(list)
    by_name = collections.Counter()
    gaps = collections.Counter()
    prev_end = w0
    for s, e, name, corr, linked in device:
        dur = (min(e, w1) - max(s, w0)) / 1e9
        launch = launches.get(corr)
        span = span_of(launch) if launch is not None else OTHER
        span_s[span] += dur
        kernel_s[name].append((e - s) / 1e9)
        by_name[short(name)] += dur
        if s > prev_end:
            gaps[f"{span}:{ops.get(linked, '?')}"] += (s - prev_end) / 1e9
        prev_end = max(prev_end, e)
    if w1 > prev_end:
        gaps["window end:host"] += (w1 - prev_end) / 1e9
    busy = _union((max(s, w0), min(e, w1)) for s, e, *_ in device) / 1e9
    return Summary(window_s=(w1 - w0) / 1e9, busy_s=busy,
                   span_device_s=dict(span_s), kernel_s=dict(kernel_s),
                   device_ops=by_name.most_common(top),
                   idle_gaps=gaps.most_common(top), events=len(device))
