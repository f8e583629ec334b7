"""lattigo_tpu_torch — the PyTorch / CUDA port of lattigo_tpu.

A second package beside :mod:`lattigo_tpu` (the JAX reference, which it
never imports): RNS rings, RLWE keys and key switching and the BGV
scheme, with residues carried as ``torch.int64`` tensors and the TPU's
Pallas kernels rewritten by hand in CUDA for Hopper (``csrc/``).

Entry points (``Parameters``, ``Ring``) run on CUDA unless the caller
passes ``device="cpu"``; without a CUDA device and without an explicit
device they raise.
"""

__version__ = "0.1.0"
