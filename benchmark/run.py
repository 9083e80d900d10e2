#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on this machine's first CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Prints one JSON line as the last line of
standard output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
`device`, with --trace 1 `breakdown`, and last `checks`, each number the
check compared beside its limit; the same numbers are the last lines of
standard error. Exits non-zero, and prints no result, when there is no
CUDA card or too few for the cell, when the program cannot be imported,
or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
START = time.perf_counter()
JAX_NAMES = {"jax", "jaxlib", "flax", "gaussian_splatting_web_tpu"}


def process_age() -> float:
    """Seconds since this process started (Linux: its start time in
    /proc; elsewhere since this module was first run)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - START


def loaded_jax() -> list:
    """JAX modules in this process, top-level names compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & JAX_NAMES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # import the benchmark as a package from the checkout's root, never its
    # modules by their bare names from this script's folder (`trace` would
    # shadow the standard library's)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != HERE]

    cache = ROOT / "benchmark" / "_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    from benchmark import harness

    cell = harness.load_cell(spec, args.workload, ROOT)
    chips = next(w["chips"] for w in spec["workloads"]
                 if w["name"] == args.workload)
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    harness.mark("cuda", process_age)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device, process_age)
    found = loaded_jax()
    if found:
        print(f"JAX modules were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
