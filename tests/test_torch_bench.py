"""The port's bench (`bench_lib.run`, `cli bench`, `utils/metrics.py`) on
the CPU at small sizes: its JSON line, its bin counts against the JAX
package's `bin_splats` of the same scene, the CLI's flags reaching the
config, the gradient-parity gate (green for the twin against itself, red
for a kernel path whose gradient is scaled by 1.01) and `time_fn`.

On the CPU the gate does not run (the kernels exist on CUDA only), so the
gate's tests put `_grad_parity` in the place of `run`'s gate call, where on
the CPU both of its paths are the plain twin. Tolerances: counts and JSON fields exact; the
twin against itself has p99 exactly 0.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from gaussian_splatting_web_tpu import bench_lib as jax_bench
from gaussian_splatting_web_tpu.config import RenderConfig as JaxConfig
from gaussian_splatting_web_tpu.core import camera as jax_camera
from gaussian_splatting_web_tpu.ops.projection import (
    project_gaussians as jax_project,
)
from gaussian_splatting_web_tpu.ops.sort import bin_splats as jax_bin
from gaussian_splatting_web_tpu_torch import bench_lib, cli
from gaussian_splatting_web_tpu_torch.config import RenderConfig
from gaussian_splatting_web_tpu_torch.core.camera import default_camera
from gaussian_splatting_web_tpu_torch.io.ply import write_ply
from gaussian_splatting_web_tpu_torch.utils.metrics import time_fn

torch.set_num_threads(2)

N, W, H = 2000, 64, 48
JSON_KEYS = {"metric", "value", "unit", "vs_baseline", "parity_gate_ok"}
RUN = bench_lib.run


@pytest.fixture(scope="module")
def bench_run():
    """One CPU run of the bench → (stdout lines, result dict)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = RUN(device="cpu", n_synthetic=N, width=W, height=H)
    return out.getvalue().splitlines(), result


@pytest.fixture
def small_ply(tmp_path):
    path = tmp_path / "scene.ply"
    write_ply(bench_lib.make_scene(300, seed=4, device="cpu"), str(path))
    return str(path)


def _mutant(monkeypatch, scale=1.01):
    """The gate's kernel path with its gradient scaled by `scale`."""
    real = bench_lib._kernel_grads

    def scaled(*args):
        loss, grads = real(*args)
        return loss, [g * scale for g in grads]

    monkeypatch.setattr(bench_lib, "_kernel_grads", scaled)


def _cli_bench(monkeypatch, capsys, argv):
    """`cli bench` → (its JSON line, the dict `run` returned)."""
    seen = {}

    def spy(*args, **kw):
        seen["result"] = RUN(*args, **kw)
        seen["config"] = kw["config"]
        return seen["result"]

    monkeypatch.setattr(bench_lib, "run", spy)
    capsys.readouterr()
    cli.main(["bench", "--device", "cpu", *argv])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0]), seen


def test_bench_json_line(bench_run):
    lines, result = bench_run
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    assert set(line) == JSON_KEYS
    assert line["metric"] == "forward_render_48p"
    assert line["unit"] == "Mpix/s"
    assert line["vs_baseline"] == round(line["value"] / 60, 3)
    assert line["parity_gate_ok"] is None
    assert not any(k.startswith("parity_") and k != "parity_gate_ok"
                   for k in result)
    assert result["device"] == "cpu"
    assert result["pct_roofline_forward"] is None     # no H100 here
    for k in ("forward", "fwd_bwd", "sort"):
        assert 0 < result[f"{k}_ms"] <= result[f"{k}_p90_ms"]


def test_bench_counts_match_jax_bin_splats(bench_run):
    """live pairs, slots, tiles and overflow of the bench's bins equal the
    JAX package's `bin_splats` of JAX `make_scene(2000)` from the bench
    camera under the same exact-mode config (integers, exact)."""
    _, result = bench_run
    cfg = JaxConfig(**dataclasses.asdict(RenderConfig()))
    cloud = jax_bench.make_scene(N)
    cam = jax_camera.default_camera(W, H, eye=(0, 0, -8.0),
                                    center=np.zeros(3))
    bins = jax_bin(jax_project(cloud, cam, W, H, cfg), W, H, cfg)
    assert result["live_pairs"] == int(bins.num_pairs) > 0
    assert result["slots"] == int(bins.sorted_slot.shape[0])
    assert result["tiles"] == int(bins.tile_count.shape[0])
    assert result["overflow"] == int(bins.overflow)


def test_cli_bench_cpu_and_render_flags(monkeypatch, capsys, small_ply):
    """`cli bench --device cpu` on a small PLY exits 0 with one JSON line;
    the shared render flags reach `run`'s config (JAX's cmd_bench drops
    them): --depth-bits 19 gives the packed key, --max-dup 8 half the
    slots."""
    argv = ["--ply", small_ply, "--width", "32", "--height", "32"]
    line, seen = _cli_bench(monkeypatch, capsys, argv)
    assert set(line) == JSON_KEYS and line["metric"] == "forward_render_32p"
    assert seen["config"] == RenderConfig()
    assert seen["result"]["slots"] == 300 * 16
    _, packed = _cli_bench(monkeypatch, capsys,
                           argv + ["--depth-bits", "19", "--max-dup", "8"])
    assert packed["config"] == RenderConfig(depth_bits=19, max_dup=8)
    assert packed["result"]["slots"] == 300 * 8 != seen["result"]["slots"]


def test_gate_green_for_twin_red_for_scaled_kernel(monkeypatch):
    cloud = bench_lib.make_scene(500, device="cpu")
    cam = default_camera(32, 32, eye=(0, 0, -8), center=(0, 0, 0))
    g = bench_lib._grad_parity(cloud, cam, 32, 32, RenderConfig())
    assert g["ok"] and g["p99"] == 0.0 and g["max"] == 0.0
    assert g["loss_rel"] == 0.0 and g["n"] == 500 * 9
    _mutant(monkeypatch)
    bad = bench_lib._grad_parity(cloud, cam, 32, 32, RenderConfig())
    assert not bad["ok"] and bad["p99"] > bench_lib.GRAD_P99


def test_red_gate_shows_in_json_line_and_cli_exit(monkeypatch, capsys,
                                                  small_ply):
    monkeypatch.setattr(bench_lib, "_gate", bench_lib._grad_parity)
    argv = ["--ply", small_ply, "--width", "32", "--height", "32"]
    line, seen = _cli_bench(monkeypatch, capsys, argv)
    assert line["parity_gate_ok"] is True
    assert seen["result"]["parity_p99"] == 0.0
    _mutant(monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = RUN(device="cpu", n_synthetic=300, width=32, height=32)
    assert json.loads(out.getvalue())["parity_gate_ok"] is False
    assert result["parity_p99"] > bench_lib.GRAD_P99
    capsys.readouterr()
    with pytest.raises(SystemExit) as exit_:
        cli.main(["bench", "--device", "cpu", *argv])
    assert exit_.value.code == 1
    assert json.loads(capsys.readouterr().out)["parity_gate_ok"] is False


def test_time_fn_median_within_p90():
    calls = []
    t = time_fn(lambda: calls.append(sum(range(20_000))), iters=7, warmup=1,
                device="cpu")
    assert len(calls) == 8                     # one warm-up, seven timed
    assert 0 < t["median"] <= t["p90"]
