"""Tiny cells of the benchmark for CPU tests: the real configuration and
traffic files, cut to a few thousand Gaussians and a small frame, run on
the CPU through the program's plain twins."""

import copy
import json
import time
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
TINY = {"num_gaussians": 2000, "width": 48, "height": 32, "views": 16}


def tiny_cell(name: str) -> harness.Cell:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(spec, name, ROOT)
    cell.config = dict(copy.deepcopy(cell.config), **TINY)
    return cell


def run_tiny(name: str, seed: int = 7, traced: bool = False) -> dict:
    start = time.perf_counter()
    return harness.run_cell(tiny_cell(name), seed, 0.3, traced, "cpu",
                            lambda: time.perf_counter() - start)


@pytest.fixture
def tiny():
    return tiny_cell
