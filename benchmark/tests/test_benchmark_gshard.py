"""The `rubble.gshard-train` cell on the CPU: its files found by name, the
loop end to end on four gloo ranks at a tiny size through the program's
plain twins, traced and not, and the blocked reference against
`train.run_steps` with tiny blocks."""

import copy
import json
import time
from pathlib import Path

import pytest

from benchmark import harness
from benchmark import inputs as inp
from benchmark.reference import blocked
from benchmark.reference import train as ref_train

ROOT = Path(__file__).resolve().parents[2]
CELL = "rubble.gshard-train"
# 64 rows of pixels: 4 rows of tiles for the mesh's 4 bands
TINY = {"num_gaussians": 2000, "width": 64, "height": 64, "views": 16}
NEW = ["gshard.exchange_ms", "gshard.return_ms", "gshard.link_pct",
       "gshard.slot_yield_pct", "gshard.band_skew", "gshard.step_mfu",
       "gshard.binning_ms", "gshard.composite_bwd_ms"]


def tiny_cell() -> harness.Cell:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(spec, CELL, ROOT)
    cell.config = dict(copy.deepcopy(cell.config), **TINY)
    return cell


def test_the_cell_s_files_are_found_by_name():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(spec, CELL, ROOT)
    assert cell.config["num_gaussians"] == 40_400_000
    assert cell.config["render"]["max_per_tile"] > \
        cell.config["max_tile_pairs"]
    assert cell.traffic["loop"] == "gshard_train"
    assert harness.load_loop(cell).run
    names = [m["name"] for m in cell.metrics]
    assert set(NEW) | {"train.idle_pct"} == set(names)
    for name in names:
        assert callable(harness.load_reader(name))
    assert {m["name"] for m in cell.end_to_end} == {
        "train_step_ms", "train_peak_gib", "setup_s"}
    work = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert work["chips"] == 4


@pytest.mark.parametrize("traced", [False, True])
def test_the_loop_runs_on_four_gloo_ranks(traced):
    start = time.perf_counter()
    res = harness.run_cell(tiny_cell(), 4000000031, 0.5, traced, "cpu",
                           lambda: time.perf_counter() - start)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"]["overflow"]["value"] == 0
    assert res["device"]["count"] == 4
    assert list(res)[-1] == "checks"
    if traced:
        m = res["metrics"]
        # the CPU trace has no device work: the counters' and the host
        # clock's metrics read, the device spans' are silent
        assert 0 < m["gshard.slot_yield_pct"]["value"] <= 100
        assert m["gshard.band_skew"]["value"] >= 1.0
        assert m["gshard.step_mfu"]["value"] > 0
    else:
        assert set(res["metrics"]) == {"train_step_ms", "train_peak_gib",
                                       "setup_s"}


def test_blocked_reference_equals_the_whole_one():
    cfg = tiny_cell().config
    data = inp.make_inputs(cfg, 4000000033, "cpu")
    targets = list(inp.make_targets(cfg, 4000000033, 3, "cpu"))
    views = [data.cameras[i] for i in data.train_ids[:3]]
    whole = ref_train.run_steps(data.scene, views, targets, cfg, data.extent)
    parts = blocked.run_steps(data.scene, views, targets, cfg, data.extent,
                              block=301)
    assert parts["loss"] == whole["loss"]
    assert parts["counts"] == whole["counts"]
    for k in ref_train.LEAVES:
        assert parts["grad_norm"][k] == pytest.approx(whole["grad_norm"][k],
                                                      rel=1e-6)
        assert parts["grad_max"][k] == whole["grad_max"][k]
        assert parts["change_norm"][k] == pytest.approx(
            whole["change_norm"][k], rel=1e-5)


def test_an_exchange_rank_0_drops_fails_the_check(monkeypatch):
    """Rank 0 takes part in every all-to-all but keeps none of the rows or
    gradients the other ranks send it: the check finds the exchange
    missing."""
    import torch

    from gaussian_splatting_web_tpu_torch.parallel import gaussian_sharded

    exchange = gaussian_sharded._all_to_all

    def dropped(x, mesh):
        return torch.zeros_like(exchange(x, mesh))

    monkeypatch.setattr(gaussian_sharded, "_all_to_all", dropped)
    start = time.perf_counter()
    res = harness.run_cell(tiny_cell(), 4000000037, 0.3, False, "cpu",
                           lambda: time.perf_counter() - start)
    assert res["correct"] is False


def test_the_control_fails_at_a_tiny_size():
    """`tools/control.py`'s readings on four gloo ranks: the program passes
    every limit, the TF32 control and the half-batch fault fail one."""
    from benchmark import check

    cell = tiny_cell()
    r = harness.load_loop(cell).readings(cell, 5, "cpu")
    limits = cell.traffic["limits"]
    assert check.judge(r["program"], limits)[0], r["program"]
    assert not check.judge(r["control"], limits)[0], r["control"]
    assert not check.judge(r["half_batch"], limits)[0], r["half_batch"]
