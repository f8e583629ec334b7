"""Galois automorphisms X → X^k on ring polynomials (STANDARD ring).

Counterpart of :mod:`lattigo_tpu.ring.automorphism`: the permutation index
(and the coefficient-domain sign mask) of each Galois element is computed
on the host as numpy and cached per (N, Galois element); applying an
automorphism is one gather over the coefficient axis (plus a select for
the sign in the coefficient domain).

NTT-domain derivation for the natural → bit-reversed ordering of the NTT:
slot j holds a(ψ^{e_j}) with e_j = 2·brev(j)+1, so (σ_k a)(ψ^{e_j}) =
a(ψ^{e_j·k mod 2N}) = NTT(a)[j'] with brev(j') = (e_j·k mod 2N − 1)/2.
The conjugate-invariant ring's index waits for that ring.
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
def _coeff_index_np(n: int, gal_el: int) -> tuple[np.ndarray, np.ndarray]:
    i = pow(gal_el, -1, 2 * n) * np.arange(n, dtype=np.int64) % (2 * n)
    neg = i >= n
    return np.where(neg, i - n, i).astype(np.int32), neg


@functools.lru_cache(maxsize=None)
def ntt_index(n: int, gal_el: int, device) -> torch.Tensor:
    """Gather index (int64[N] on ``device``) of the NTT-domain automorphism."""
    return torch.from_numpy(_ntt_index_np(n, gal_el).astype(np.int64)).to(device)


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


def automorphism_ntt(x, n: int, gal_el: int):
    return apply_ntt(x, ntt_index(n, gal_el, x.device))
