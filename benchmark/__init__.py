"""The benchmark of the PyTorch and CUDA port: BENCHMARK.json at the root of the repository names
its cells and metrics; `python3 -m benchmark.run` runs one cell once (run.py)."""

import time

T0 = time.perf_counter()  # a run's set-up counts from here: imported first, before torch and the program
