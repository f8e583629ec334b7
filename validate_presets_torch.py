#!/usr/bin/env python3
"""Validate the published bootstrap preset recipes at a reduced ring degree
on the PyTorch/CUDA port: the counterpart of ``validate_presets.py``, with
its arguments, default list of eight presets and line.

    python3 validate_presets_torch.py [preset ...] [--log-n 9]               # on the card
    python3 validate_presets_torch.py [preset ...] [--log-n 9] --device cpu

Prints ``NAME @ logN=N: W bits worst-slot / A avg (Ss)`` a preset. See
``lattigo_tpu_torch/circuits/preset_validator.py``.
"""

import sys

from lattigo_tpu_torch.circuits.preset_validator import main

if __name__ == "__main__":
    main()
    sys.exit(0)
