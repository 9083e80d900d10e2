"""The port's spans and counters (`utils/tracing.py`) on the CPU: the
"gs/" ranges of a frame and a training step under `torch.profiler`, nested
as the layers are; the step's backward nodes mapped to the forward spans
they came from; nothing entered and nothing counted with tracing off; and
the binning counters, host ints, against the frames' own counts."""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core import camera as cam
from gaussian_splatting_web_tpu_torch.core.types import GaussianCloud
from gaussian_splatting_web_tpu_torch.models.gaussian_model import (
    GaussianModel,
)
from gaussian_splatting_web_tpu_torch.ops.rasterize import render_impl
from gaussian_splatting_web_tpu_torch.train.densify import pad_to_capacity
from gaussian_splatting_web_tpu_torch.train.train_loop import (
    make_densify_train_step,
)
from gaussian_splatting_web_tpu_torch.train.trainer import (
    TrainState,
    make_optimizer,
)
from gaussian_splatting_web_tpu_torch.utils import tracing

torch.set_num_threads(2)

W, H = 64, 48
CFG = RenderConfig(max_per_tile=24)   # small enough that tiles are cut
EVAL = "autograd::engine::evaluate_function: "


def _cloud(n=300, seed=0, sh_degree=1) -> GaussianCloud:
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    k = (sh_degree + 1) ** 2
    return GaussianCloud.from_numpy(type("C", (), dict(
        xyz=rng.normal(size=(n, 3)) * 0.8,
        log_scale=rng.uniform(-3.0, -1.5, size=(n, 3)),
        quat=q / np.linalg.norm(q, axis=1, keepdims=True),
        opacity_logit=rng.uniform(-1.0, 2.0, size=n),
        sh=rng.normal(scale=0.3, size=(n, k, 3)))))


def _camera(i=0):
    a = 0.4 * i
    return cam.default_camera(W, H, eye=(5 * np.sin(a), -5 * np.cos(a), 3))


def _trainer(cloud, config=CFG):
    model = GaussianModel(cloud.xyz, cloud.log_scale, cloud.quat,
                          cloud.opacity_logit, cloud.sh[:, :1],
                          cloud.sh[:, 1:])
    params, dstate = pad_to_capacity(model, model.num_gaussians + 20)
    state = TrainState(model=params, optimizer=make_optimizer(params))
    step = make_densify_train_step(W, H, config, 0.2)
    target = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(1))

    def run():
        nonlocal state, dstate
        state, dstate, loss = step(state, dstate, _camera(), target, 1)
        return loss

    return run


def _gs_ranges(prof):
    """(name, parent name or None, start_ns, end_ns, thread) of every gs/
    range, the parent being the innermost gs/ range around it on its
    thread."""
    ranges = sorted(
        (e.start_ns(), -e.end_ns(), e.name()[len(tracing.PREFIX):],
         e.start_thread_id())
        for e in prof.profiler.kineto_results.events()
        if e.is_user_annotation() and e.name().startswith(tracing.PREFIX))
    out, open_ = [], collections.defaultdict(list)
    for start, neg_end, name, tid in ranges:
        stack = open_[tid]
        while stack and stack[-1][1] <= start:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None, start, -neg_end,
                    tid))
        stack.append((name, -neg_end))
    return out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


@pytest.mark.parametrize("binning", ["dup", "anchor"])
def test_frame_and_step_spans_nest_as_the_layers(binning):
    cloud = _cloud()
    cfg = dataclasses.replace(CFG, binning=binning)
    step = _trainer(cloud, cfg)

    def work():
        with torch.no_grad():
            render_impl(cloud, _camera(), W, H, cfg)
        step()

    pairs = {(n, p) for n, p, *_ in _gs_ranges(_profiled(work))}
    assert {("render", None), ("projection", "render"),
            ("binning", "render"), ("composite", "render"),
            ("step", None), ("projection", "step"), ("binning", "step"),
            ("composite", "step"), ("loss", "step"), ("backward", "step"),
            ("adam", "step"), ("densify_stats", "step")} <= pairs
    if binning == "dup":
        assert ("fold", "composite_bwd") in pairs
    # the backward runs on the calling thread on the CPU, on the autograd
    # engine's own thread (no parent) on a card
    assert ({p for n, p in pairs if n == "composite_bwd"}
            <= {"backward", None})


def test_every_backward_node_maps_to_a_forward_layer():
    step = _trainer(_cloud())
    step()                                   # Adam's state exists
    prof = _profiled(step)
    events = prof.profiler.kineto_results.events()
    ranges = _gs_ranges(prof)
    # ops that make no node record the number the next node will take, so
    # the last forward op with a node's number is the one that made it
    forward = {}
    for e in events:
        if (e.sequence_nr() >= 0 and not e.is_user_annotation()
                and e.fwd_thread_id() == 0):
            key = (e.start_thread_id(), e.sequence_nr())
            forward[key] = max(forward.get(key, 0), e.start_ns())

    def innermost(t, tid):
        inside = [r for r in ranges if r[4] == tid and r[2] <= t <= r[3]]
        return max(inside, key=lambda r: r[2])[0] if inside else None

    nodes = [e for e in events if e.name().startswith(EVAL)]
    assert len(nodes) > 20
    layers = collections.Counter()
    for e in nodes:
        name = e.name()[len(EVAL):]
        if e.sequence_nr() < 0:
            assert "AccumulateGrad" in name, name
            continue
        t = forward[(e.fwd_thread_id(), e.sequence_nr())]
        layers[innermost(t, e.fwd_thread_id())] += 1
    assert set(layers) == {"projection", "loss", "composite"}, layers


class _Entered(Exception):
    pass


def test_tracing_off_enters_no_range_and_counts_nothing(monkeypatch):
    cloud = _cloud()
    step = _trainer(cloud)
    with torch.no_grad():
        _profiled(lambda: render_impl(cloud, _camera(), W, H, CFG))
    before = tracing.counters()
    assert before["binning.slots"] > 0

    def refuse(*a, **k):
        raise _Entered("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not tracing.on()
    with torch.no_grad():
        render_impl(cloud, _camera(1), W, H, CFG)
    step()
    assert tracing.counters() == before
    assert tracing.span("x") is tracing.span("y")     # the shared no-op


def _counted(fn):
    """What the counters gained over `fn()` run under a CPU profiler."""
    before = tracing.counters()
    _profiled(fn)
    return {k: v - before.get(k, 0) for k, v in tracing.counters().items()}


def test_binning_counters_add_up_the_frames_counts():
    cloud = _cloud(seed=3)
    pairs = []

    def frames():
        with torch.no_grad():
            for i in range(3):
                _, aux = render_impl(cloud, _camera(i), W, H, CFG)
                pairs.append(int(aux["num_pairs"]))

    got = _counted(frames)
    assert got["binning.live_pairs"] == sum(pairs) > 0
    assert got["binning.slots"] == 3 * CFG.max_dup * cloud.xyz.shape[0]


@pytest.mark.parametrize("binning", ["dup", "anchor"])
def test_counters_hold_host_ints_only(binning):
    """Counting launches no device work: every counter is a Python int,
    and the anchor binning, whose pair count is a device value, counts
    nothing."""
    cloud = _cloud(seed=2)
    cfg = dataclasses.replace(CFG, binning=binning)
    step = _trainer(cloud, cfg)
    got = _counted(step)
    assert all(type(v) is int for v in tracing.counters().values())
    if binning == "dup":
        # the arena's capacity: 20 rows over the cloud
        assert got["binning.slots"] == cfg.max_dup * (cloud.xyz.shape[0] + 20)
        assert 0 < got["binning.live_pairs"] < got["binning.slots"]
    else:
        assert not any(got.values())


def test_live_pairs_count_only_what_the_gather_cap_keeps():
    cloud = _cloud(seed=3)
    cfg = dataclasses.replace(CFG, gather_cap_factor=0.5, gather_cap_floor=1)
    aux = {}

    def frame():
        with torch.no_grad():
            aux.update(render_impl(cloud, _camera(), W, H, cfg)[1])

    got = _counted(frame)
    assert int(aux["overflow"]) > 0            # the cap cut pairs
    assert got["binning.live_pairs"] == int(aux["num_pairs"]) == 150


def test_spanned_keeps_the_function_and_opens_its_range():
    @tracing.spanned("loss")
    def f(x, *, y=1):
        """Doc."""
        return x + y

    assert f.__name__ == "f" and f.__doc__ == "Doc." and f(1, y=2) == 3
    prof = _profiled(lambda: f(1))
    assert [n for n, *_ in _gs_ranges(prof)] == ["loss"]


def test_tracing_is_on_only_while_a_profiler_records():
    assert not tracing.on()
    seen = []
    _profiled(lambda: seen.append((tracing.on(), tracing.span("render"))))
    assert not tracing.on()
    assert seen[0][0] and seen[0][1] is not tracing.span("render")
