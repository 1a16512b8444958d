#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port on one NVIDIA GPU, one cell a run.

    python3 benchmark_torch/run.py --workload qwen3-asr-0.6b.dictation --seed 7 --seconds 10 --trace 0

The cells, metrics and bounds are in ``BENCHMARK.json``; the harness is
``benchmark_torch/harness/`` (see ``harness/runner.py``). The last line of
standard output is the run's result as one JSON object.
"""

import os
import sys
import time

T_PROCESS = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_process=T_PROCESS))
