"""Galois automorphisms X → X^k on ring polynomials.

Counterpart of :mod:`lattigo_tpu.ring.automorphism`: the permutation index
(and the coefficient-domain sign mask) of each Galois element is computed
on the host as numpy and cached per (N, Galois element); applying an
automorphism is one gather over the coefficient axis (plus a select for
the sign in the coefficient domain).

NTT-domain derivation for the natural → bit-reversed ordering of the NTT:
slot j holds a(ψ^{e_j}) with e_j = 2·brev(j)+1, so (σ_k a)(ψ^{e_j}) =
a(ψ^{e_j·k mod 2N}) = NTT(a)[j'] with brev(j') = (e_j·k mod 2N − 1)/2.

On the conjugate-invariant ring (``ring_type``) slot j holds the value at
the exponent E(j) = 2·brev_{log2N}(j)+1 of the 4N-th root (the kept half of
the size-2N transform, always ≡ 1 mod 4); σ_k reads the value at E(j)·k,
with the conjugate exponents e and 4N − e identified (CI values agree).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lattigo_tpu_torch.ring.ntt import bit_reverse_array


@functools.lru_cache(maxsize=None)
def _ntt_index_np(n: int, gal_el: int) -> np.ndarray:
    logn = n.bit_length() - 1
    brev = bit_reverse_array(logn)
    e = (2 * brev + 1) * gal_el % (2 * n)
    return brev[(e - 1) // 2].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ntt_index_ci_np(n: int, gal_el: int) -> np.ndarray:
    if gal_el % 2 != 1:
        raise ValueError(f"Galois element {gal_el} is even")
    brev = bit_reverse_array(n.bit_length())       # over log2(2N) bits
    e = (2 * brev[:n] + 1) * gal_el % (4 * n)
    e = np.where(e % 4 != 1, 4 * n - e, e)
    return brev[(e - 1) // 2].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _coeff_index_np(n: int, gal_el: int) -> tuple[np.ndarray, np.ndarray]:
    i = pow(gal_el, -1, 2 * n) * np.arange(n, dtype=np.int64) % (2 * n)
    neg = i >= n
    return np.where(neg, i - n, i).astype(np.int32), neg


@functools.lru_cache(maxsize=None)
def ntt_index(n: int, gal_el: int, device, ring_type: str = "standard") -> torch.Tensor:
    """Gather index (int64[N] on ``device``) of the NTT-domain automorphism
    on a ring of ``ring_type``."""
    fn = _ntt_index_ci_np if ring_type == "conjugate_invariant" else _ntt_index_np
    return torch.from_numpy(fn(n, gal_el).astype(np.int64)).to(device)


@functools.lru_cache(maxsize=None)
def _coeff_index(n: int, gal_el: int, device):
    idx, neg = _coeff_index_np(n, gal_el)
    return (torch.from_numpy(idx.astype(np.int64)).to(device),
            torch.from_numpy(neg).to(device))


def apply_ntt(x, idx):
    """NTT-domain automorphism: one gather over the coefficient axis."""
    return x.index_select(-1, idx)


def apply_coeff(x, n: int, gal_el: int, q):
    """Coefficient-domain automorphism with its sign flips.

    x: int64[..., L, N] in [0, q); q: int64[L, 1].
    """
    idx, neg = _coeff_index(n, gal_el, x.device)
    g = x.index_select(-1, idx)
    return torch.where(neg & (g != 0), q - g, g)


def automorphism_ntt(x, n: int, gal_el: int, ring_type: str = "standard"):
    return apply_ntt(x, ntt_index(n, gal_el, x.device, ring_type))
