"""One run of one cell: what every traffic loop shares.

A cell names a configuration (`configs/<name>.json`, the file that
`BENCHMARK.json` gives), a traffic mix (`traffic/<name>.json`) and, through
`BENCHMARK.json`, the per-layer metrics (`metrics/<name>.py`); all three are
found by name. A traffic mix's `loop` names the module that drives it,
`loops/<loop>.py`, found by name in the same way: its `run` does the
set-up, the measured window and the check against the reference, and hands
the numbers to `result` here. The mix's `limits` hold the limit of each
number its loop compares.

The program is `gaussian_splatting_web_tpu_torch`; its modules are
imported only when a run starts.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional

import torch

from . import check, trace as tr, work
from .reference import render as ref_render

BENCH_DIR = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    metrics: List[dict]        # per-layer metric entries of BENCHMARK.json
    end_to_end: List[dict]     # end-to-end metric entries that apply
    bench_dir: Path = BENCH_DIR


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(spec: dict, name: str, root: Path,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of the benchmark spec (BENCHMARK.json's contents),
    its files found by name: the configuration's `file` under `root`, the
    traffic mix under `bench_dir/traffic/`."""
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in the benchmark")
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{work['traffic']}.json").read_text())
    return Cell(name=name, config=config, traffic=traffic,
                metrics=[m for m in spec["per_layer"] if applies(m, name)],
                end_to_end=[m for m in spec["end_to_end"]
                            if applies(m, name)], bench_dir=bench_dir)


@functools.lru_cache(maxsize=None)
def load_module(path: Path):
    """The Python file at `path`, loaded once."""
    mod_name = "benchmark_" + "".join(
        c if c.isalnum() else "_" for c in path.stem + path.parent.name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """`read` of metrics/<name>.py."""
    return load_module(bench_dir / "metrics" / f"{name}.py").read


def load_loop(cell: Cell):
    """The module loops/<loop>.py that drives the cell's traffic."""
    return load_module(cell.bench_dir / "loops" / f"{cell.traffic['loop']}.py")


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader gets from a traced run."""
    loop: str                  # the traffic's loop
    config: dict
    requests: int              # frames or steps in the traced window
    window_s: float            # the traced window, host clock
    summary: Optional[tr.Summary]
    counts: List[ref_render.Counts]   # the reference's, checked requests
    syncs_per_request: Optional[float] = None


def program_render_config(config: dict):
    """The program's RenderConfig with the configuration's render rules."""
    from gaussian_splatting_web_tpu_torch.config import RenderConfig

    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    kw = {k: v for k, v in config["render"].items() if k in fields}
    kw["background"] = tuple(kw["background"])
    return RenderConfig(**kw)


def program_camera(cam: dict):
    from gaussian_splatting_web_tpu_torch.core.types import CameraParams

    return CameraParams(**cam)


def sync(device) -> None:
    if is_cuda(device):
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if is_cuda(device):
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def release(device) -> None:
    gc.collect()
    if is_cuda(device):
        torch.cuda.empty_cache()


def mark(stage: str, clock: Callable[[], float]) -> None:
    """The set-up's split on standard error: seconds since the process
    started, at the end of each stage."""
    print(f"setup {stage} {clock():.2f} s", file=sys.stderr, flush=True)


def p95(values: List[float]) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


class maybe:
    """`cm` as a context manager, or nothing when it is None; the seconds
    its exit took go to stderr under `label` (the profiler's stop)."""

    def __init__(self, cm, label=None):
        self.cm = cm
        self.label = label

    def __enter__(self):
        return self.cm.__enter__() if self.cm is not None else None

    def __exit__(self, *exc):
        if self.cm is None:
            return False
        t0 = time.perf_counter()
        out = self.cm.__exit__(*exc)
        if self.label:
            print(f"{self.label} {time.perf_counter() - t0:.2f} s",
                  file=sys.stderr, flush=True)
        return out


def window_range(traced: bool):
    return (torch.profiler.record_function(tr.WINDOW) if traced
            else maybe(None))


def profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if is_cuda(device):
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, record_shapes=False,
                   profile_memory=False, with_stack=False)


def device_info(device, peak: int) -> dict:
    if is_cuda(device):
        dev = torch.device(device)
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": peak}


def reduce_trace(prof) -> tr.Summary:
    """The trace's summary, with the time its reduction took on stderr."""
    t0 = time.perf_counter()
    s = tr.reduce(prof)
    print(f"trace {s.events} device events reduced in "
          f"{time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)
    return s


def result(cell, numbers, metrics, ctx, attempted, failed, peak, device,
           traced) -> dict:
    """The run's result line: `numbers` judged by the traffic's limits,
    the end-to-end `metrics` (untraced) or the per-layer metrics read from
    `ctx` (traced), and the device."""
    correct, checks = check.judge(numbers, cell.traffic["limits"])
    dev = device_info(device, peak)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.metrics}
    out = {"correct": correct, "attempted": attempted, "failed": failed}
    if traced:
        if ctx.counts:
            shape = work.shape(cell.config, ctx.counts)
            print("work " + " ".join(f"{k}={v:.6g}" for k, v in
                                     shape._asdict().items()),
                  file=sys.stderr, flush=True)
        values = {}
        for m in cell.metrics:
            v = load_reader(m["name"], cell.bench_dir)(ctx)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": units[m["name"]]}
        out["metrics"] = values
        s = ctx.summary
        dev["busy_s"] = s.busy_s
        dev["window_s"] = s.window_s
        out["device"] = dev
        out["breakdown"] = {"device_ops": [list(x) for x in s.device_ops],
                            "idle_gaps": [list(x) for x in s.idle_gaps]}
    else:
        out["metrics"] = {m["name"]: {"value": metrics[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
        out["device"] = dev
    out["checks"] = checks
    return out


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             setup_clock: Callable[[], float]) -> dict:
    return load_loop(cell).run(cell, seed, seconds, traced, device,
                               setup_clock)
