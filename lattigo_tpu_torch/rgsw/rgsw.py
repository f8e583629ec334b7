"""RGSW encryption and the external product.

Counterpart of :mod:`lattigo_tpu.rgsw.rgsw`. Keys of one shape are drawn
together on a leading batch axis (:meth:`Encryptor.encrypt_monomials`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lattigo_tpu_torch.ring.ringqp import QPPoly
from lattigo_tpu_torch.rlwe.elements import Ciphertext as RlweCiphertext
from lattigo_tpu_torch.rlwe.evaluator import Evaluator as RlweEvaluator
from lattigo_tpu_torch.rlwe.keys import (
    GadgetCiphertext, KeyGenerator, SecretKey, unstack_gadgets,
)
from lattigo_tpu_torch.rlwe.params import Parameters


@dataclass
class Ciphertext:
    """RGSW(m) = (gadget with m·g on c0, gadget with m·g on c1)."""

    c0: GadgetCiphertext
    c1: GadgetCiphertext


def monomials(params: Parameters, powers: list[int], level_q: int | None = None):
    """X^k for each k of ``powers``, NTT + Montgomery over Q:
    int64[len(powers), lq+1, N]."""
    p = params
    rq = p.ring_q
    level_q = p.max_level if level_q is None else level_q
    k = torch.tensor([int(v) % (2 * p.n) for v in powers], dtype=torch.int64)
    coeff = torch.zeros((len(powers), level_q + 1, p.n), dtype=torch.int64)
    coeff[torch.arange(len(powers)), :, k % p.n] = 1
    coeff = coeff.to(p.device)
    # X^k = X^{k-N}·X^N = −X^{k-N} for k ≥ N
    neg = (k >= p.n).to(p.device)[:, None, None]
    coeff = torch.where(neg, rq.neg(coeff, level_q), coeff)
    return rq.mform(rq.ntt(coeff, level_q), level_q)


class Encryptor:
    """RGSW encryption under a secret key."""

    def __init__(self, params: Parameters, sk: SecretKey):
        self.params = params
        self.sk = sk
        self.kgen = KeyGenerator(params)

    def encrypt(self, gen: torch.Generator, m_q, level_q: int | None = None,
                batch: tuple[int, ...] = ()) -> Ciphertext:
        """Encrypt m (Q part, NTT + Montgomery, int64[*batch, lq+1, N])."""
        enc = self.kgen.gadget_encrypt
        return Ciphertext(
            c0=enc(gen, m_q, self.sk, level_q, row=0, batch=batch),
            c1=enc(gen, m_q, self.sk, level_q, row=1, batch=batch))

    def encrypt_monomials(self, gen: torch.Generator, powers: list[int],
                          level_q: int | None = None) -> list[Ciphertext]:
        """RGSW(X^k) for every k of ``powers``, drawn in one batch."""
        ct = self.encrypt(gen, monomials(self.params, powers, level_q), level_q,
                          batch=(len(powers),))
        return [Ciphertext(a, b) for a, b in
                zip(unstack_gadgets(ct.c0), unstack_gadgets(ct.c1))]

    def encrypt_monomial(self, gen: torch.Generator, power: int,
                         level_q: int | None = None) -> Ciphertext:
        """RGSW(X^power), the blind rotation's key."""
        return self.encrypt_monomials(gen, [power], level_q)[0]


def external_product(ev: RlweEvaluator, ct: RlweCiphertext,
                     rgsw: Ciphertext) -> RlweCiphertext:
    """RLWE(μ) ⊠ RGSW(m) → RLWE(μ·m).

    Both RLWE components are RNS-decomposed in one call and MAC'd against
    the matching gadget half; the two QP accumulators merge before one
    ModDown.
    """
    p = ev.params
    if ct.degree != 1 or not ct.is_ntt:
        raise ValueError("external_product takes a degree-1 NTT ciphertext")
    level = ct.level
    d = ev.decompose_ntt(ct.value, level)          # [..., 2, beta, l, N]
    acc0 = ev.gadget_product_hoisted_lazy(
        QPPoly(d.q[..., 0, :, :, :], d.p[..., 0, :, :, :]), rgsw.c0, level)
    acc1 = ev.gadget_product_hoisted_lazy(
        QPPoly(d.q[..., 1, :, :, :], d.p[..., 1, :, :, :]), rgsw.c1, level)
    out = p.basis_extender.mod_down_qp_to_q(
        p.ring_q.add(acc0.q, acc1.q, level), p.ring_p.add(acc0.p, acc1.p),
        level, ntt_domain=True)
    return ct.replace(value=out)
