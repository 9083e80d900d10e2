"""The reduction of the program's own spans (`program_trace.py`): each
rule that places a device operation, the host's waits at syncs, the
requests read, and the existing `trace.reduce` summary left as it was;
the readers silent on a program without the tracing module and loud on a
traced run they cannot read; and the new readers in tiny traced cells, on
the CPU and on a card."""

import dataclasses
import gc
import sys
import time
import types

import pytest
import torch

from benchmark import harness
from benchmark import program_trace as pt
from benchmark import trace
from benchmark.tests.conftest import run_tiny, tiny_cell

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA
US = 1000                      # the fake clock's microsecond, in ns


@dataclasses.dataclass
class Ev:
    """A profiler event with the methods the reductions call."""
    n: str
    s: float
    e: float
    corr: int = 0
    linked: int = 0
    tid: int = 1
    seq: int = -1
    fwd: int = 0
    dev: bool = False
    annot: bool = False

    def name(self):
        return self.n

    def start_ns(self):
        return int(self.s * US)

    def duration_ns(self):
        return int((self.e - self.s) * US)

    def device_type(self):
        return CUDA if self.dev else CPU

    def is_user_annotation(self):
        return self.annot

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def start_thread_id(self):
        return self.tid

    def sequence_nr(self):
        return self.seq

    def fwd_thread_id(self):
        return self.fwd


def span(name, s, e, corr, tid=1):
    return Ev(name, s, e, corr=corr, tid=tid, annot=True)


def launch(op, op_corr, corr, t, kernel_s, kernel_e, tid=1, seq=-1,
           kernel="k"):
    """An op at t, its runtime call and the kernel it launched."""
    return [Ev(op, t, t + 0.5, corr=op_corr, tid=tid, seq=seq),
            Ev("cudaLaunchKernel", t + 0.2, t + 0.4, corr=corr,
               linked=op_corr),
            Ev(kernel, kernel_s, kernel_e, corr=corr, linked=op_corr,
               dev=True)]


def step_events(with_gs=True):
    """One training step and a second, empty one: the main thread (1)
    runs the forward and waits in `backward`, the autograd thread (2) the
    nodes; the loop copies a frame to the host between the steps."""
    node = pt.NODE
    gs = [
        span("gs/step", 10, 90, 1),
        span("gs/projection", 11, 20, 2),
        span("gs/loss", 21, 30, 3),
        span("gs/backward", 31, 70, 4),
        span("gs/composite_bwd", 47, 59, 5, tid=2),
        span("gs/fold", 53, 58, 6, tid=2),
        span("gs/adam", 71, 80, 7),
        span("gs/binning", 81, 88, 8),
        span("gs/step", 95, 99, 9),
    ]
    ev = [
        span(trace.WINDOW, 0, 100, 10),
        span("bench/projection", 11, 20, 11),
        span("bench/loss", 21, 30, 12),
        span("bench/backward", 30.5, 70.5, 13),
        # a no-node op with the number the mm takes, outside projection
        Ev("aten::to", 10.5, 10.6, corr=100, seq=5),
        *launch("aten::mm", 101, 201, 12, 14, 18, seq=5),
        *launch("aten::sub", 102, 202, 22, 24, 26, seq=6),
        Ev("cudaStreamSynchronize", 27, 29, corr=203, linked=102),
        *launch("aten::ones_like", 103, 204, 32, 34, 35),
        Ev(node + "SubBackward0", 36, 40, corr=104, tid=2, seq=6, fwd=1),
        *launch("aten::mul", 105, 205, 37, 39, 42, tid=2),
        Ev(node + "MmBackward0", 41, 45, corr=106, tid=2, seq=5, fwd=1),
        *launch("aten::mm", 107, 206, 42, 44, 48, tid=2),
        Ev(node + "CompositeFnBackward", 46, 60, corr=108, tid=2, seq=7,
           fwd=1),
        # kernel B, launched through ctypes inside the span
        Ev("cudaLaunchKernel", 48, 48.1, corr=207, linked=5),
        Ev("raster_bwd_kernel", 49, 52, corr=207, linked=5, dev=True),
        *launch("aten::index_copy_", 110, 208, 54, 56, 57, tid=2),
        Ev(node + "torch::autograd::AccumulateGrad", 61, 63, corr=111,
           tid=2),
        *launch("aten::copy_", 112, 209, 61.5, 63, 64, tid=2),
        *launch("aten::_foreach_add_", 113, 210, 72, 74, 76),
        Ev("aten::nonzero", 82, 86, corr=115),
        Ev("cudaMemcpyAsync", 83, 85, corr=212, linked=115),
        Ev("Memcpy DtoH (Device -> Pinned)", 84, 84.5, corr=212,
           linked=115, dev=True),
        Ev("aten::copy_", 91, 95, corr=114),
        Ev("cudaMemcpyAsync", 92, 95, corr=211, linked=114),
        Ev("Memcpy DtoH (Device -> Pageable)", 93, 94, corr=211,
           linked=114, dev=True),
    ]
    ev += gs if with_gs else []
    return sorted(ev, key=lambda x: x.s)


def test_each_rule_places_the_work_it_should():
    p = pt.reduce(step_events())
    ms = {k: round(v * 1e9 / US, 3) for k, v in p.device_s.items()}
    assert ms == {
        "step/projection": 4.0,            # rule 1, main thread
        "step/loss": 2.0,
        "step/backward": 2.0,              # the seed's fill; AccumulateGrad
        "step/loss.bwd": 3.0,              # rule 2: node 6 → loss
        "step/projection.bwd": 4.0,        # node 5 → the mm, not the `to`
        "composite_bwd": 3.0,              # rule 1, autograd thread
        "composite_bwd/fold": 1.0,
        "step/adam": 2.0,
        "step/binning": 0.5,
        "other": 1.0,                      # the loop's own copy
    }
    assert p.requests == 2
    assert p.total("composite_bwd") == pytest.approx(4 * US / 1e9)
    assert p.total("fold") == pytest.approx(US / 1e9)
    assert p.total("composite") is None
    waits = {k: round(v * 1e9 / US, 3) for k, v in p.sync_wait_s.items()}
    assert waits == {"step/loss": 2.0, "step/binning": 2.0, "other": 3.0}
    assert p.waits() == pytest.approx(4 * US / 1e9)
    gaps = dict(p.idle_gaps)
    assert p.idle_gaps[0][0] == "step/adam:aten::_foreach_add_"
    assert gaps["step/adam:aten::_foreach_add_"] == pytest.approx(1e-5)
    assert gaps["step/backward:aten::ones_like"] == pytest.approx(8e-6)


def test_the_summary_is_the_same_with_the_programs_spans():
    def prof(events):
        return types.SimpleNamespace(profiler=types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(events=lambda: events)))

    plain = trace.reduce(prof(step_events(with_gs=False)))
    with_gs = trace.reduce(prof(step_events()))
    assert plain == with_gs
    assert plain.span_device_s["backward"] > 0
    pt.reduce(step_events())
    assert trace.reduce(prof(step_events())) == with_gs


def test_only_the_first_seconds_are_read_and_reading_stops():
    ev = []
    for i in range(60):                    # a request each 0.5 s
        t = i * 500_000.0
        ev += [span("gs/render", t, t + 100, 1000 + i),
               *launch("aten::add", 2000 + i, 3000 + i, t + 1, t + 2,
                       t + 4)]
    ev = sorted(ev, key=lambda x: x.s)
    p = pt.reduce(ev, seconds=10.0)
    assert p.requests == 20
    assert p.device_s == {"render": pytest.approx(20 * 2 * US / 1e9)}
    assert p.events < len(ev) * 0.6
    assert pt.reduce(ev, seconds=60.0).requests == 60
    assert pt.reduce([e for e in ev if e.n != "gs/render"]) is None


def test_readers_are_silent_without_a_profile_or_the_programs_tracing(
        monkeypatch):
    ctx = types.SimpleNamespace(summary=None, requests=5)
    assert pt.of_run(ctx) is None           # an untraced run
    assert pt.counters(ctx) is None
    ctx.summary = object()
    monkeypatch.setitem(sys.modules,
                        "gaussian_splatting_web_tpu_torch.utils.tracing",
                        None)               # the parent: no tracing module
    assert pt.of_run(ctx) is None
    assert pt.counters(ctx) is None
    assert pt.per_request_ms(ctx, "composite") is None


def _traced(events):
    """Calls a reader with a profiler holding `events` in a local variable,
    as the loops do."""
    prof = torch.profiler.profile()
    prof.profiler = types.SimpleNamespace(kineto_results=types.SimpleNamespace(
        events=lambda: events))
    ctx = types.SimpleNamespace(summary=object(), requests=2)

    def read(reader):
        return reader(ctx)

    return prof, read


def test_readers_raise_on_a_traced_run_they_cannot_read():
    ctx = types.SimpleNamespace(summary=object(), requests=5)
    with pytest.raises(RuntimeError, match="no torch.profiler.profile"):
        pt.of_run(ctx)                      # no profiler among the callers
    prof, read = _traced([e for e in step_events() if e.n != "gs/step"])
    with pytest.raises(RuntimeError, match="no gs/render or gs/step"):
        read(pt.of_run)
    prof, read = _traced(step_events())
    with pytest.raises(RuntimeError, match="no device work"):
        read(lambda c: pt.per_request_ms(c, "composite"))


def test_a_run_is_reduced_once_and_held_weakly():
    def one_run():
        prof, read = _traced(step_events())
        assert read(lambda c: pt.per_request_ms(c, "fold")) == (
            pytest.approx(1e3 * US / 1e9 / 2))
        first = pt._last[1]
        read(lambda c: pt.per_request_ms(c, "loss"))
        assert pt._last[1] is first and pt._last[0]() is prof

    one_run()
    gc.collect()
    assert pt._last[0]() is None


def test_tiny_traced_cells_read_the_programs_spans_and_counters():
    view = run_tiny("tandt.view", traced=True)
    got = view["metrics"]
    assert 0 < got["view.pair_yield_pct"]["value"] < 100
    assert got["view.sync_wait_ms"]["value"] == 0.0    # no CUDA syncs
    assert "view.composite_ms" not in got              # no device work
    train = run_tiny("tandt.train", traced=True)
    assert not {"train.loss_ms", "train.fold_ms"} & set(train["metrics"])
    assert train["correct"] and view["correct"]


NEW = {"view": ["view.composite_ms", "view.pair_yield_pct",
                "view.sync_wait_ms"],
       "train": ["train.loss_ms", "train.loss_bwd_ms",
                 "train.projection_bwd_ms", "train.composite_bwd_ms",
                 "train.fold_ms"]}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["tandt.view", "tandt.train"])
def test_tiny_traced_cells_on_a_card_read_every_new_metric(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    start = time.perf_counter()
    out = harness.run_cell(tiny_cell(name), 7, 0.3, True, "cuda",
                           lambda: time.perf_counter() - start)
    got = out["metrics"]
    for metric in NEW[name.split(".")[1]]:
        assert got[metric]["value"] >= 0, metric
    assert out["correct"]
