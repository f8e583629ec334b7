"""Precision statistics: the CKKS test oracle.

Counterpart of :mod:`lattigo_tpu.schemes.ckks.precision`: compares decoded
values against a plaintext-side recomputation and reports min/max/avg log2
precision (host numpy).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PrecisionStats:
    min_precision: float
    max_precision: float
    avg_precision: float
    median_precision: float
    std_error: float

    def __str__(self) -> str:
        return (f"PrecisionStats(min={self.min_precision:.2f}, "
                f"avg={self.avg_precision:.2f}, max={self.max_precision:.2f}, "
                f"median={self.median_precision:.2f} bits)")


def get_precision_stats(want, have) -> PrecisionStats:
    """log2-precision stats of ``have`` against ``want``."""
    want = np.asarray(want, dtype=np.complex128).ravel()
    have = np.asarray(have, dtype=np.complex128).ravel()[: want.size]
    err = np.abs(want - have)
    err = np.maximum(err, 2.0 ** -80)  # floor to avoid inf
    prec = -np.log2(err)
    return PrecisionStats(
        min_precision=float(prec.min()),
        max_precision=float(prec.max()),
        avg_precision=float(prec.mean()),
        median_precision=float(np.median(prec)),
        std_error=float(err.std()),
    )


def verify_test_vectors(want, have, min_precision: float) -> PrecisionStats:
    """Raise unless the average precision reaches ``min_precision`` bits."""
    stats = get_precision_stats(want, have)
    if stats.avg_precision < min_precision:
        raise AssertionError(
            f"precision too low: {stats} < required avg {min_precision}")
    return stats
