"""Additive-share types for plaintext-space secret sharing.

Counterpart of :mod:`lattigo_tpu.multiparty.additive_shares`: a share in
Z_Q[X] (RNS residues, one tensor) and a share in Z (Python integers, for
masks whose flooding bound can exceed Q). The E2S / S2E protocols produce
and consume shares implicitly; these types give user code an object to
allocate and aggregate. Aggregation is associative addition.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class AdditiveShare:
    """Additively shared value in Z_Q[X]: int64[..., level+1, N] residues."""

    value: torch.Tensor

    def aggregate(self, other: "AdditiveShare", ring,
                  level: int | None = None) -> "AdditiveShare":
        """self + other mod Q."""
        return AdditiveShare(ring.add(self.value, other.value, level))


def new_additive_share(ring, level: int | None = None,
                       batch: tuple[int, ...] = ()) -> AdditiveShare:
    """A zero share over ``ring``."""
    return AdditiveShare(ring.zero(level, batch))


@dataclass
class AdditiveShareBigint:
    """Additively shared value in Z: Python integers, exact at any bound."""

    value: list[int] = field(default_factory=list)

    def aggregate(self, other: "AdditiveShareBigint") -> "AdditiveShareBigint":
        if len(self.value) != len(other.value):
            raise ValueError("shares of different lengths")
        return AdditiveShareBigint([a + b for a, b in zip(self.value, other.value)])

    def to_numpy_signed(self) -> np.ndarray:
        """int64 view (raises on overflow: only for bounded masks)."""
        return np.array(self.value, dtype=np.int64)


def new_additive_share_bigint(n: int) -> AdditiveShareBigint:
    """n zero integer shares."""
    return AdditiveShareBigint([0] * n)
