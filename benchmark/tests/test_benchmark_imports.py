"""What the benchmark imports: never JAX or the JAX package, and in the
reference nothing of the program either (top-level names compared
whole)."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX = {"jax", "jaxlib", "flax", "gaussian_splatting_web_tpu"}
PORT = "gaussian_splatting_web_tpu_torch"


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not top_level_imports(path) & JAX, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert PORT not in top_level_imports(path), path


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    # a whole tiny run on the CPU, with every metric reader and loop loaded
    code = (
        "import json, time\n"
        "from pathlib import Path\n"
        "from benchmark import harness\n"
        "import benchmark.tools.control\n"
        "spec = json.loads(Path('BENCHMARK.json').read_text())\n"
        "for m in spec['per_layer']: harness.load_reader(m['name'])\n"
        "for w in spec['workloads']:\n"
        "    harness.load_loop(harness.load_cell(spec, w['name'], Path('.')))\n"
        "cell = harness.load_cell(spec, 'tandt.view', Path('.'))\n"
        "cell.config.update(num_gaussians=500, width=32, height=32, "
        "views=8)\n"
        "harness.run_cell(cell, 3, 0.1, False, 'cpu', time.perf_counter)\n")
    mods = loaded_after(code)
    assert PORT in mods
    assert not mods & JAX, mods & JAX


def test_the_reference_alone_loads_nothing_of_the_program():
    mods = loaded_after("import benchmark.reference.render, "
                        "benchmark.reference.train")
    assert PORT not in mods and not mods & JAX
