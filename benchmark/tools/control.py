#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from, on the card at the
cell's own size, for many seeds in one process:

    python3 benchmark/tools/control.py --workload <cell> --seeds 1 2 3 ...

For each seed it prints one JSON line with the check's numbers, as the
`readings` of the cell's traffic loop (`loops/<name>.py`) gives them:
  * "program": the program's checked frames or first steps, as a run of
    the cell checks them (the lower readings);
  * "control": the reference computed in TF32 put in the program's place
    (the precision below the configurations' float32 without TF32);
  * "half_batch" (training cells): the program with its loss taken over
    the top half of each image only, the mean over the rest.
The benchmark's own runs never run this. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != HERE]
    from benchmark import harness

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(spec, args.workload, ROOT)
    device = torch.device("cuda", 0)
    loop = harness.load_loop(cell)
    for seed in args.seeds:
        out = loop.readings(cell, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
        harness.release(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
