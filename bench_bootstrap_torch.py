#!/usr/bin/env python3
"""One full CKKS bootstrap of the PyTorch/CUDA port, measured on one CUDA
card: the counterpart of ``bench_bootstrap.py``, with its presets and
arguments (a driver, not the benchmark: it writes no file).

    python3 bench_bootstrap_torch.py [log_n] [batch]
    python3 bench_bootstrap_torch.py --preset N15QP768_H192_H32 [batch] [--log-n K] [--once]
    python3 bench_bootstrap_torch.py ... --device cpu

Prints one JSON line: seconds per bootstrap, ms per stage, worst and mean
bits, peak device memory. See ``lattigo_tpu_torch/circuits/bootstrap_driver.py``.
"""

import sys

from lattigo_tpu_torch.circuits.bootstrap_driver import main

if __name__ == "__main__":
    sys.exit(main())
