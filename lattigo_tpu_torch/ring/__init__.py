"""RNS polynomial ring arithmetic on ``torch.int64`` tensors.

Counterpart of :mod:`lattigo_tpu.ring`: negacyclic NTT (radix-2 plain
engine and the four-step digit-matmul engine with its CUDA kernel),
Montgomery/Barrett modular arithmetic, RNS basis extension and rescaling,
and samplers.
"""

from lattigo_tpu_torch.ring.ring import Ring, SubRing
from lattigo_tpu_torch.ring import modops

__all__ = ["Ring", "SubRing", "modops"]
