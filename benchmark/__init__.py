"""The benchmark of the PyTorch/CUDA port (`gaussian_splatting_web_tpu_torch`).

`run.py` runs one cell of `BENCHMARK.json` once and prints one JSON line.
Everything the measurement rests on lives here and nowhere in the program:
the scene, camera and target generator (`inputs.py`), the plain reference
(`reference/`), the table of peaks (`peaks.py`), the trace reduction
(`trace.py`), the comparison that decides `correct` (`check.py`), and one
file per configuration, traffic mix and per-layer metric, found by name.
See README.md.
"""
