#!/usr/bin/env python3
"""Correctness gate of the PyTorch/CUDA port on one CUDA card: the
counterpart of ``tpu_gate.py`` (its four gates: known-answer vectors, every
engine against radix-2 and each kernel against its plain version, one
bootstrap, the published preset's precision).

    python3 gpu_gate.py                 # on the card (raises without one)
    python3 gpu_gate.py --device cpu    # the plain versions on the CPU
    python3 gpu_gate.py --full          # more prime classes, preset at logN 15

Exits non-zero with the failing check's traceback when a gate fails; prints
one JSON line of results when all pass. See ``lattigo_tpu_torch/gate.py``.
"""

import sys

from lattigo_tpu_torch.gate import main

if __name__ == "__main__":
    sys.exit(main())
