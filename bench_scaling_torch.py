#!/usr/bin/env python3
"""Data-parallel scaling of a batched CKKS step on the PyTorch/CUDA port:
the counterpart of ``bench_scaling.py``, with its step, arguments and JSON
line.

    python3 bench_scaling_torch.py [n_ranks] [batch]               # on the card
    python3 bench_scaling_torch.py [n_ranks] [batch] --device cpu

``rotate(rescale(mul_relin(c, c)), 1)`` at CKKS logN 12 on a batch of
``batch`` (default 16) runs in one process, then on ``n_ranks`` (default 4)
ranks with the batch sharded over dp. Prints one JSON line:

    {"metric": "dp_scaling_batched_ckks_eval", "n_devices": N, "batch": B,
     "collectives_on_dp_axis": 0, "bit_exact": true, "t_1dev_s": ...,
     "t_Ndev_s": ..., "wallclock_ratio_shared_cores": ...}

and fails unless the dp axis moved no byte and the result is bit-exact. On
one card the ranks share it, so the ratio is no scaling figure. See
``lattigo_tpu_torch/parallel/scaling.py``.
"""

import sys

from lattigo_tpu_torch.parallel.scaling import main

if __name__ == "__main__":
    main()
    sys.exit(0)
