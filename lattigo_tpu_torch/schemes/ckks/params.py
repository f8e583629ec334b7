"""CKKS parameters: RLWE parameters + default scale / slot geometry.

Counterpart of :mod:`lattigo_tpu.schemes.ckks.params`. Scales are exact
rationals (:class:`fractions.Fraction`), host metadata beside the residue
tensors: no precision is lost across any number of rescalings.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from fractions import Fraction

from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.ring.ring import CONJUGATE_INVARIANT


@dataclass(frozen=True)
class ParametersLiteral(rlwe.ParametersLiteral):
    """RLWE literal + the log2 of the default scale."""

    log_default_scale: int = 45


class Parameters(rlwe.Parameters):
    """Resolved CKKS parameters on ``device`` (CUDA unless the caller names
    another device); ciphertexts are always kept in the NTT domain."""

    def __init__(self, literal: ParametersLiteral, device=None):
        super().__init__(replace(literal, ntt_flag=True), device)
        self.log_default_scale = literal.log_default_scale
        self.default_scale_fraction = Fraction(1 << literal.log_default_scale)

    @property
    def max_slots(self) -> int:
        """N/2 complex slots (standard ring); N real slots (CI ring)."""
        return self.n if self.ring_type == CONJUGATE_INVARIANT else self.n // 2

    @property
    def log_max_slots(self) -> int:
        return self.max_slots.bit_length() - 1

    def q_fraction(self, level: int) -> Fraction:
        return Fraction(self.q_moduli[level])
