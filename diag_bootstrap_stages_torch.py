#!/usr/bin/env python3
"""Per-stage bootstrap error audit of the PyTorch/CUDA port: the
counterpart of ``diag_bootstrap_stages.py``, with its arguments and lines
(so the two outputs diff line by line).

    python3 diag_bootstrap_stages_torch.py [log_n] [preset]               # on the card
    python3 diag_bootstrap_stages_torch.py [log_n] [preset] --device cpu

``log_n`` (default 9) cuts the preset (default ``N15QP768_H192_H32``) to
that ring degree. One bootstrap runs through the port's ``on_stage`` hook;
each stage is decrypted and held against its exact integer payload. See
``lattigo_tpu_torch/circuits/bootstrap_diag.py``.
"""

import sys

from lattigo_tpu_torch.circuits.bootstrap_diag import main

if __name__ == "__main__":
    sys.exit(main())
