"""Plain NumPy reference for the CKKS cells: the answers a request is due,
worked out from the messages, and a decryption and decoding of what the
program returned, from the secret key's coefficients alone.

Nothing here imports the program. Its outputs are read only to be judged:
the residues of each ciphertext, its NTT and Montgomery flags and its scale.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from hebench.reference import rns


# -- the answers ----------------------------------------------------------------

def want_step(a: np.ndarray, b: np.ndarray, diags: dict[int, np.ndarray]) -> np.ndarray:
    """M·(a∘b) for the transformation whose k-th diagonal is diags[k]:
    out[j] = Σ_k diags[k][j]·(a∘b)[(j + k) mod slots]."""
    ab = a * b
    out = np.zeros_like(ab)
    for k, d in diags.items():
        out += d * np.roll(ab, -k, axis=-1)
    return out


def want_ptmul(a: np.ndarray, w: np.ndarray) -> np.ndarray:
    return a * w


# -- decryption and decoding ------------------------------------------------------

class SecretKey:
    """s from its signed coefficients, transformed once per chain prefix."""

    def __init__(self, coeffs: np.ndarray, moduli: list[int]):
        self.coeffs = np.asarray(coeffs, dtype=np.int64)
        self.moduli = list(moduli)
        self._ntt: dict[int, np.ndarray] = {}

    def ntt(self, level: int) -> np.ndarray:
        if level not in self._ntt:
            top = max(self._ntt, default=-1)
            if top >= level:
                return self._ntt[top][: level + 1]
            mods = self.moduli[: level + 1]
            self._ntt[level] = rns.ntt(rns.lift_small(self.coeffs, mods), mods)
        return self._ntt[level]


def decrypt(value: np.ndarray, is_ntt: bool, is_montgomery: bool,
            sk: SecretKey) -> np.ndarray:
    """Σ_i c_i·s^i mod q over limbs, coefficients [L, N] (uint64); value is
    [degree+1, L, N] (uint64)."""
    level = value.shape[-2] - 1
    mods = sk.moduli[: level + 1]
    q = np.asarray(mods, dtype=np.uint64)[:, None]
    c = value % q
    if not is_ntt:
        c = np.stack([rns.ntt(ci, mods) for ci in c])
    s = sk.ntt(level)
    acc = c[-1]
    for ci in c[-2::-1]:
        acc = (rns.mulmod(acc, s, q) + ci) % q
    if is_montgomery:
        rinv = np.array([pow(1 << 64, -1, m) for m in mods], dtype=np.uint64)[:, None]
        acc = rns.mulmod(acc, rinv, q)
    return rns.intt(acc, mods)


def decode(m: np.ndarray, scale) -> np.ndarray:
    """Slots z[j] = m(ζ^(5^j mod 2N)) / scale, ζ = e^(iπ/N): the canonical
    embedding of the integer polynomial m[N] (float64)."""
    n = m.shape[-1]
    zeta_k = np.exp(1j * np.pi * np.arange(n) / n)
    vals = np.fft.ifft(m.astype(np.float64) * zeta_k) * n     # m(ζ^(2t+1))
    e = np.ones(n // 2, dtype=np.int64)
    for j in range(1, n // 2):
        e[j] = e[j - 1] * 5 % (2 * n)
    return vals[(e - 1) // 2] / float(Fraction(scale))


def judge(value: np.ndarray, is_ntt: bool, is_montgomery: bool, scale,
          sk: SecretKey, want: np.ndarray, headroom_bits: int = 16) -> dict:
    """One ciphertext's verdict: its residues that no small integer
    explains (``crt_mismatch``) and its slots' largest error against
    ``want`` (``max_err``)."""
    coeffs = decrypt(value, is_ntt, is_montgomery, sk)
    level = value.shape[-2] - 1
    bits = int(np.log2(float(Fraction(scale)))) + headroom_bits
    m, bad = rns.crt_small(coeffs, sk.moduli[: level + 1], bits)
    got = decode(m, scale)
    return {"crt_mismatch": bad, "max_err": float(np.max(np.abs(got - want)))}
