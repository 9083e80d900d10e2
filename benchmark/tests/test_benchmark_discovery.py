"""A configuration, a traffic mix, a traffic loop of a new kind and a
per-layer metric added as new files are found by name, with no edit to a
file already there."""

import json
import shutil
import time
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def copy_with_toy_config(tmp_path):
    """A copy of the benchmark in `tmp_path` with one new configuration
    file, "toy" → (bench folder, spec)."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "_cache", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "tandt.json").read_text())
    cfg.update(name="toy", num_gaussians=400, width=32, height=32, views=8)
    (bench / "configs" / "toy.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "toy", "source": "toy",
                            "file": "benchmark/configs/toy.json",
                            "reduced": [], "why": "toy"})
    return bench, spec


def test_new_files_are_found_by_name(tmp_path):
    bench, spec = copy_with_toy_config(tmp_path)
    traffic = json.loads((BENCH / "traffic" / "view.json").read_text())
    traffic["checked_frames"] = 2
    (bench / "traffic" / "view_two.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "view.frames_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.requests)\n")

    spec["workloads"].append({"name": "toy.view_two", "config": "toy",
                              "traffic": "view_two", "chips": 1,
                              "why": "toy"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "tandt.view" in m["workloads"]:
            m["workloads"].append("toy.view_two")
    spec["per_layer"].append({"name": "view.frames_seen", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "render_fps",
                              "workloads": ["toy.view_two"]})

    cell = harness.load_cell(spec, "toy.view_two", tmp_path, bench)
    assert cell.config["num_gaussians"] == 400
    assert cell.traffic["checked_frames"] == 2
    assert [m["name"] for m in cell.metrics] == ["view.frames_seen"]

    res = harness.run_cell(cell, 11, 0.2, True, "cpu", time.perf_counter)
    assert res["correct"] is True
    assert res["metrics"]["view.frames_seen"]["value"] == res["attempted"]
    assert list(res)[-1] == "checks"

    plain = harness.run_cell(cell, 11, 0.2, False, "cpu", time.perf_counter)
    assert set(plain["metrics"]) == {"render_fps", "frame_p95_ms",
                                     "setup_s"}


NEW_LOOP = '''
"""A loop of a kind the benchmark did not have: the reference's frames
of a few views, timed, each compared with itself."""
import time

from benchmark import harness, inputs as inp
from benchmark.loops import view


def run(cell, seed, seconds, traced, device, setup_clock):
    cfg = cell.config
    data = inp.make_inputs(cfg, seed, device)
    setup_s = setup_clock()
    t0 = time.perf_counter()
    frames, counts = view.reference_frames(cfg, data, data.test_ids)
    window_s = time.perf_counter() - t0
    gap = max(float((f - f.clone()).abs().max()) for f in frames)
    ctx = harness.Context(loop="reference_frames", config=cfg,
                          requests=len(frames), window_s=window_s,
                          summary=None, counts=counts)
    metrics = {"reference_fps": len(frames) / window_s, "setup_s": setup_s}
    return harness.result(cell, {"self_gap": gap}, metrics, ctx,
                          len(frames), 0, 0, device, traced)
'''


def test_a_traffic_loop_of_a_new_kind_is_found_by_name(tmp_path):
    bench, spec = copy_with_toy_config(tmp_path)
    (bench / "loops" / "reference_frames.py").write_text(NEW_LOOP)
    (bench / "traffic" / "ref_views.json").write_text(json.dumps(
        {"loop": "reference_frames", "why": "toy",
         "limits": {"self_gap": 0.0}}))
    spec["workloads"].append({"name": "toy.ref_views", "config": "toy",
                              "traffic": "ref_views", "chips": 1,
                              "why": "toy"})
    spec["end_to_end"].append({"name": "reference_fps", "unit": "frames/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["toy.ref_views"]})

    cell = harness.load_cell(spec, "toy.ref_views", tmp_path, bench)
    res = harness.run_cell(cell, 12, 0.2, False, "cpu", time.perf_counter)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"reference_fps", "setup_s"}
    assert res["checks"] == {"self_gap": {"value": 0.0, "limit": 0.0}}
    assert res["attempted"] == 1          # one test view among 8
