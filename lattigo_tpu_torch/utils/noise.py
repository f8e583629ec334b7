"""Noise telemetry: the empirical noise of a ciphertext against a known
plaintext, for calibrating parameters and catching noise-budget
regressions.

Counterpart of :mod:`lattigo_tpu.utils.noise`; host-side (the centred
coefficients are Python integers).
"""

from __future__ import annotations

import math

import numpy as np


def log2_std(values) -> float:
    """log2 of the standard deviation of centred integer samples."""
    s = np.array([float(x) for x in values]).std()
    return math.log2(s) if s > 0 else float("-inf")


def ciphertext_noise(params, sk, ct, pt_value=None) -> list[int]:
    """The centred coefficients e of one ciphertext that decrypts to
    pt + e: with ``pt_value`` (int64[L, N] coefficients) it is subtracted,
    without it e is the whole decrypted polynomial."""
    from lattigo_tpu_torch.rlwe.encryption import Decryptor

    pt = Decryptor(params, sk).decrypt(ct)
    v = pt.value
    if pt.is_ntt:
        v = params.ring_q.intt(v, pt.level)
    level = pt.level
    if pt_value is not None:
        level = min(pt.level, pt_value.shape[-2] - 1)
        v = params.ring_q.sub(v[..., : level + 1, :],
                              pt_value[..., : level + 1, :], level)
    return params.ring_q.to_int_coeffs(v, level, centered=True)


def log2_noise_std(params, sk, ct, pt_value=None) -> float:
    """log2 of the standard deviation of :func:`ciphertext_noise`."""
    return log2_std(ciphertext_noise(params, sk, ct, pt_value))
