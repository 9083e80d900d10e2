"""The program's own spans in a traced run: device time by "gs/" span path,
the backward split by layer, and the host's waits at syncs.

The port opens a profiler range "gs/<name>" at each layer boundary
whenever a profiler records (`gaussian_splatting_web_tpu_torch/utils/
tracing.py`): `render` and `step` at the top, `projection`, `binning`,
`composite`, `loss`, `backward`, `adam` and `densify_stats` under them,
and `composite_bwd` with its `fold` in the compositor's backward, which
runs on the autograd engine's thread on a card. A span's path joins the
names of the spans open around it on its thread: "step/loss",
"composite_bwd/fold".

`reduce` reads the profiler's events in a pass of its own (`trace.reduce`
and its `Summary` are left as they are), over the requests (gs/render or
gs/step) that start in the first `SECONDS` of the window: a pass over the
whole window takes as long as `trace.reduce`'s, tens of seconds, and a
request's device time hardly varies. It places each device operation
(kernel, copy or set) that those requests launched in one path, as self
time:

1. the innermost gs/ span open on the thread that launched it, when that
   span opened inside the autograd node around the launch, or no node is
   around it;
2. else the forward span of that node plus ".bwd": the node
   (`autograd::engine::evaluate_function: ...`) carries the sequence
   number of the forward op that made it, and the op's start places it
   in a span ("step/projection.bwd");
3. else the innermost gs/ span open on any thread (the latest opened);
4. else "other".

A launch's thread is that of the CPU op it is linked to (the innermost
profiler range open when it launched). The host's waits are the host
times of `cudaStreamSynchronize`, `cudaDeviceSynchronize` and
`cudaEventSynchronize`, and of the memcpy calls whose device copy is
device to host, each placed in the innermost gs/ span on its thread (by
rule 3 when the call links to no op), else in "other".

`harness.Context` carries the reduced `Summary` and not the profiler, so
`of_run` finds the traced run's profiler among its callers' local
variables, and reduces it once however many readers ask; it keeps only a
weak reference to it. A traced run of a program with the tracing module
in which no profiler, no request span or no device work in a read span is
found raises, so a lost span fails the run instead of silencing its
metric; a program without the module (the parent of the change that
added it) reads nothing and raises nothing.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import importlib
import sys
import time
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from benchmark import trace

PREFIX = "gs/"
OTHER = "other"
REQUESTS = ("render", "step")   # the program's span of one frame, one step
SECONDS = 10.0                  # the part of the window that is read
NODE = "autograd::engine::evaluate_function: "
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


@dataclasses.dataclass
class Program:
    requests: int                    # frames or steps read
    read_s: float                    # the host time they span
    device_s: Dict[str, float]       # span path → device seconds, self
    sync_wait_s: Dict[str, float]    # span path → host seconds at syncs
    idle_gaps: List[Tuple[str, float]]   # "<path>:<op>" → idle seconds
    events: int                      # events read

    def total(self, name: str) -> Optional[float]:
        """Device seconds of every path with `name` among its parts (the
        span's self time and its children's), None when none has."""
        hits = [s for p, s in self.device_s.items()
                if name in p.split("/")]
        return sum(hits) if hits else None

    def waits(self) -> float:
        """Host seconds blocked at syncs inside gs/ spans."""
        return sum(s for p, s in self.sync_wait_s.items() if p != OTHER)


class _Timeline:
    """The innermost of nested intervals at a time: built from (start,
    end, value) intervals of one thread; `at(t)` gives the value of the
    innermost interval open at t and its start, or None."""

    def __init__(self, intervals, value_of=lambda parent, v: v):
        self.times: List[int] = []
        self.values: list = []
        stack = []
        for start, end, v in sorted(intervals,
                                    key=lambda x: (x[0], -x[1])):
            while stack and stack[-1][1] <= start:
                self._pop(stack)
            val = value_of(stack[-1][2] if stack else None, v)
            stack.append((start, end, val))
            self.times.append(start)
            self.values.append((val, start))
        while stack:
            self._pop(stack)

    def _pop(self, stack):
        _, end, _ = stack.pop()
        self.times.append(end)
        self.values.append((stack[-1][2], stack[-1][0]) if stack else None)

    def at(self, t):
        i = bisect.bisect_right(self.times, t) - 1
        return self.values[i] if i >= 0 else None


def _path(parent: Optional[str], name: str) -> str:
    return name if parent is None else f"{parent}/{name}"


def reduce(events, seconds: float = SECONDS, top: int = 10
           ) -> Optional[Program]:
    """The program part of a trace's events (as
    `prof.profiler.kineto_results.events()` gives them) over the requests
    that start within `seconds` of the first request in the window
    ("bench/window", when the trace has one): the work they launched, the
    waits they made. None when the trace holds no request span. Reading
    stops past that part when the events come in order of their start, as
    the profiler gives them."""
    spans = collections.defaultdict(list)    # thread → (s, e, name)
    nodes = collections.defaultdict(list)    # thread → (s, e, node)
    forward: Dict[Tuple[int, int], int] = {}  # (thread, seq) → op start
    op_thread: Dict[int, int] = {}           # correlation → thread
    op_name: Dict[int, str] = {}
    runtime: Dict[int, Tuple[int, int, str, int]] = {}
    device = []
    copy_kind: Dict[int, str] = {}
    request_starts = []
    w0 = cut = None
    prev, in_order, read = -1, True, 0
    cpu = torch.autograd.DeviceType.CPU
    for e in events:
        read += 1
        start = e.start_ns()
        in_order = in_order and start >= prev
        prev = start
        if e.device_type() != cpu:
            if not e.is_user_annotation():
                corr = e.correlation_id()
                device.append((start, start + e.duration_ns(), corr,
                               e.linked_correlation_id()))
                name = e.name()
                if name.startswith("Memcpy"):
                    copy_kind[corr] = name
                if in_order and cut is not None and start > cut + 2e9:
                    break       # a launch before the cut has run by now
            continue
        if cut is not None and start >= cut:
            continue
        name = e.name()
        corr = e.correlation_id()
        if name.startswith("cu"):
            runtime[corr] = (start, e.duration_ns(), name,
                             e.linked_correlation_id())
            continue
        tid = e.start_thread_id()
        op_thread[corr] = tid
        if name.startswith(PREFIX):
            name = name[len(PREFIX):]
            spans[tid].append((start, start + e.duration_ns(), name))
            if name in REQUESTS and (w0 is None or start >= w0):
                if request_starts and (start - request_starts[0]
                                       >= seconds * 1e9):
                    cut = start
                else:
                    request_starts.append(start)
            continue
        if name == trace.WINDOW:
            w0 = start
            continue
        op_name[corr] = name
        seq = e.sequence_nr()
        if name.startswith(NODE):
            nodes[tid].append((start, start + e.duration_ns(),
                               (e.fwd_thread_id(), seq)))
        elif seq >= 0 and e.fwd_thread_id() == 0:
            # ops that make no node record the number the next node takes:
            # the last op with a number is the one that made it
            key = (tid, seq)
            if start > forward.get(key, -1):
                forward[key] = start
    if not request_starts:
        return None
    w0 = request_starts[0]                   # the first request read
    if cut is None:
        cut = max(s[1] for tid in spans for s in spans[tid]
                  if s[2] in REQUESTS)

    span_at = {tid: _Timeline(iv, _path) for tid, iv in spans.items()}
    node_at = {tid: _Timeline(iv) for tid, iv in nodes.items()}

    def innermost(tid, t):
        tl = span_at.get(tid)
        return tl.at(t) if tl is not None else None

    def on_any_thread(t):
        found = [x for x in (tl.at(t) for tl in span_at.values()) if x]
        return max(found, key=lambda x: x[1])[0] if found else None

    def place(linked, t) -> str:
        tid = op_thread.get(linked)
        if tid is not None:
            sp = innermost(tid, t)
            nd = node_at[tid].at(t) if tid in node_at else None
            if sp is not None and (nd is None or sp[1] >= nd[1]):
                return sp[0]
            if nd is not None and nd[0][0] and nd[0][1] >= 0:
                op = forward.get(nd[0])
                fwd = innermost(nd[0][0], op) if op is not None else None
                if fwd is not None:
                    return fwd[0] + ".bwd"
        return on_any_thread(t) or OTHER

    device_s = collections.Counter()
    gaps = collections.Counter()
    prev_end = None
    for s, e, corr, linked in sorted(device):
        call = runtime.get(corr)
        if call is None or not w0 <= call[0] < cut:
            continue
        path = place(linked, call[0])
        device_s[path] += (e - s) / 1e9
        if prev_end is not None and s > prev_end:
            gaps[f"{path}:{op_name.get(linked, '?')}"] += (s - prev_end) / 1e9
        prev_end = e if prev_end is None else max(prev_end, e)

    waits = collections.Counter()
    for corr, (start, dur, name, linked) in runtime.items():
        if w0 <= start < cut and (
                name in SYNCS or (name.startswith("cudaMemcpy")
                                  and "DtoH" in copy_kind.get(corr, ""))):
            waits[place(linked, start)] += dur / 1e9
    return Program(requests=len(request_starts), read_s=(cut - w0) / 1e9,
                   device_s=dict(device_s), sync_wait_s=dict(waits),
                   idle_gaps=gaps.most_common(top), events=read)


def report(p: Program, out=sys.stderr) -> None:
    """The program part on `out`, per request: device ms and sync waits by
    path, and the largest idle gaps."""
    print(f"program read {p.requests} requests over {p.read_s:.2f} s, "
          f"{p.events} events", file=out)
    ms = 1e3 / p.requests
    for path in sorted(set(p.device_s) | set(p.sync_wait_s),
                       key=lambda k: -p.device_s.get(k, 0.0)):
        print(f"program {path} device_ms={ms * p.device_s.get(path, 0):.4f}"
              f" sync_wait_ms={ms * p.sync_wait_s.get(path, 0):.4f}",
              file=out)
    for label, s in p.idle_gaps:
        print(f"program idle gap {label} {s:.4f} s", file=out)
    out.flush()


_last: list = [None, None]  # a weak reference to the profiler reduced
                            # last, and its Program


def _profiler_of_callers():
    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, torch.profiler.profile):
                return value
        frame = frame.f_back
    return None


def of_run(ctx) -> Optional[Program]:
    """The program part of the traced run that calls a reader with `ctx`;
    None on an untraced run or a program without the tracing module,
    whose trace holds no gs/ span. On a traced run of a program that has
    the module, finding no profiler or no request span is a fault and
    raises."""
    if ctx.summary is None or _tracing() is None:
        return None
    prof = _profiler_of_callers()
    if prof is None:
        raise RuntimeError("no torch.profiler.profile among the callers of "
                           "a reader of the program's spans")
    if _last[0] is None or _last[0]() is not prof:
        t0 = time.perf_counter()
        p = reduce(prof.profiler.kineto_results.events())
        print(f"program trace reduced in {time.perf_counter() - t0:.2f} s",
              file=sys.stderr)
        if p is None:
            raise RuntimeError("the traced run holds no gs/render or "
                               "gs/step span")
        report(p)
        _last[:] = [weakref.ref(prof), p]
    return _last[1]


def per_request_ms(ctx, *names: str) -> Optional[float]:
    """Device ms per request in the spans `names` (summed); None when
    `of_run` gives None or the trace holds no device work (a CPU run).
    Raises when the device ran work but none of it in those spans."""
    p = of_run(ctx)
    if p is None or not p.device_s:
        return None
    totals = [t for t in (p.total(n) for n in names) if t is not None]
    if not totals:
        raise RuntimeError(f"no device work in the program's spans {names}")
    return 1e3 * sum(totals) / p.requests


def _tracing():
    """The program's tracing module, None when the program has none."""
    try:
        return importlib.import_module(
            "gaussian_splatting_web_tpu_torch.utils.tracing")
    except ImportError:
        return None


def counters(ctx) -> Optional[Dict[str, int]]:
    """The program's counters on a traced run, None on an untraced run or
    a program without the tracing module."""
    if ctx.summary is None:
        return None
    tracing = _tracing()
    return None if tracing is None else tracing.counters()
