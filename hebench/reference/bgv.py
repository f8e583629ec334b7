"""Plain NumPy reference for the BGV cells: the answer a request is due,
worked out from the messages, and a decryption and decoding of what the
program returned, from the secret key's coefficients alone, as Lattigo
v6's BGV defines them.

A BGV plaintext m ∈ R_T travels in R_Q as m·T^{-1} (the MSB encoding), so
a ciphertext at level l decrypts to c0 + c1·s = (m·scale)·T^{-1} + e mod
Q_l; times T and lifted centred it is the integer polynomial m·scale +
T·e, exact while it stays below Q_l / 2. Reduced mod T and divided by the
scale it is m, whose slots are its values at the odd powers of T's own
primitive 2N-th root ζ: row 0 of the 2 × N/2 slot matrix at ζ^(5^j), row 1
at ζ^(-5^j).

Nothing here imports the program. Its outputs are read only to be judged:
the residues of each ciphertext, its NTT and Montgomery flags and its scale.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from hebench.reference import rns
from hebench.reference.ckks import decrypt


# -- the answer -------------------------------------------------------------------

def want_mul(a: np.ndarray, b: np.ndarray, t: int) -> np.ndarray:
    """Slot-wise a·b mod T (a, b in [0, T), T < 2^31)."""
    return np.asarray(a, dtype=np.int64) * np.asarray(b, dtype=np.int64) % t


# -- decryption and decoding ------------------------------------------------------

@lru_cache(maxsize=None)
def slot_order(n: int) -> np.ndarray:
    """order[j]: the index, in :func:`rns.ntt`'s output (slot k holds the
    value at ζ^(2·brev(k)+1)), of logical slot j: ζ^(5^j) for j < N/2 and
    ζ^(-5^j) for the j - N/2 of row 1."""
    brev = rns.bit_reverse(n)
    e = np.ones(n // 2, dtype=np.int64)
    for j in range(1, n // 2):
        e[j] = e[j - 1] * 5 % (2 * n)
    odd = np.concatenate([e, 2 * n - e])          # the exponents, both rows
    return brev[(odd - 1) // 2]


def decode(m: np.ndarray, scale: int, t: int) -> np.ndarray:
    """The slots of the integer polynomial m[N] (any ints): m mod T times
    scale^{-1} mod T, evaluated at ζ^(±5^j) (int64[N], in [0, T))."""
    n = m.shape[-1]
    x = np.asarray(np.mod(m, t), dtype=np.int64) * pow(int(scale), -1, t) % t
    evals = rns.ntt(x[None, :].astype(np.uint64), [t])[0]
    return evals[slot_order(n)].astype(np.int64)


def judge(value: np.ndarray, is_ntt: bool, is_montgomery: bool, scale,
          sk, want: np.ndarray, t: int, bits: int) -> dict:
    """One ciphertext's verdict: its residues that no integer below
    2^``bits`` explains (``crt_mismatch``), its slots that differ from
    ``want`` (``slot_mismatch``) and the largest |coefficient| of T times
    its decryption, lifted centred (``noise``, a Python int)."""
    coeffs = decrypt(value, is_ntt, is_montgomery, sk)
    mods = sk.moduli[: value.shape[-2]]
    q = np.asarray(mods, dtype=np.uint64)[:, None]
    tm = rns.mulmod(coeffs, np.asarray([t % m for m in mods], dtype=np.uint64)[:, None], q)
    _, bad = rns.crt_small(tm, mods, bits)
    m = rns.crt_centred(tm, mods)
    got = decode(m, scale, t)
    return {"crt_mismatch": bad,
            "slot_mismatch": int(np.count_nonzero(got != want)),
            "noise": max(abs(int(m.max())), abs(int(m.min())))}


def checks(judged: list[dict], limits: dict) -> dict:
    """The BGV numbers compared, each {"value", "limit"}, over the judged
    ciphertexts: residues no small integer explains, slots that differ
    from the answer, and log2 of the largest lifted coefficient."""
    worst = max((r["noise"] for r in judged), default=0)
    return {
        "crt_mismatch": {"value": sum(r["crt_mismatch"] for r in judged), "limit": 0},
        "slot_mismatch": {"value": sum(r["slot_mismatch"] for r in judged), "limit": 0},
        "noise_log2": {"value": math.log2(worst) if worst else 0.0,
                       "limit": limits["noise_log2"]},
    }


def judge_sample(s: dict, sk, cfg: dict, limits: dict) -> dict:
    """:func:`judge` of one sample as the request kinds hand it over; the
    CRT check holds the lift to 16 bits above the noise limit."""
    return judge(s["value"], s["is_ntt"], s["is_montgomery"], s["scale"], sk, s["want"],
                 cfg["t"], math.ceil(limits["noise_log2"]) + 16)
