"""The control: the reference computed in TF32, the precision below the
configurations' float32 without TF32, put in the program's place, comes
out not correct. On the CPU at a tiny size; on the card at the cells' own
size (`tools/control.py` prints the readings the limits were set from)."""

import pytest
import torch

from benchmark import check, harness

from conftest import tiny_cell


@pytest.mark.parametrize("name", ["tandt.view", "tandt.train"])
def test_control_fails_at_a_tiny_size(name):
    cell = tiny_cell(name)
    r = harness.load_loop(cell).readings(cell, 5, "cpu")
    assert check.judge(r["program"], cell.traffic["limits"])[0], r["program"]
    ok, _ = check.judge(r["control"], cell.traffic["limits"])
    assert not ok, r["control"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mipnerf360.train", "tandt.view",
                                  "mipnerf360.view", "tandt.train"])
def test_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = harness.load_cell(spec, name, root)
    loop = harness.load_loop(cell)
    for seed in (4000000001, 4000000002, 4000000003):
        r = loop.readings(cell, seed, torch.device("cuda", 0))
        assert check.judge(r["program"], cell.traffic["limits"])[0], (
            seed, r["program"])
        ok, _ = check.judge(r["control"], cell.traffic["limits"])
        assert not ok, (seed, r["control"])
        harness.release(torch.device("cuda", 0))
