"""Key material containers + key generation.

Counterpart of :mod:`lattigo_tpu.rlwe.keys` (secret keys, RNS gadget
ciphertexts, relinearization keys). Key polynomials live in the NTT +
Montgomery domain over R_QP, so every key-switch MAC is one ``mred_lazy``.
Randomness comes from an explicit ``torch.Generator``.

Gadget layout: at level l with |P| = alpha the l+1 limbs split into
beta = ceil((l+1)/alpha) digits; the gadget entry for digit d is P mod q_j
on rows [d·alpha, (d+1)·alpha) and 0 elsewhere.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lattigo_tpu_torch.ring import modops, sampling
from lattigo_tpu_torch.ring.ring import u64_tensor
from lattigo_tpu_torch.ring.ringqp import QPPoly, stack as qp_stack
from lattigo_tpu_torch.rlwe.params import Parameters


def _mform_int(a: int, q: int) -> int:
    return (a << 64) % q


@dataclass
class SecretKey:
    """s ∈ R_QP in NTT + Montgomery form."""

    value: QPPoly


@dataclass
class GadgetCiphertext:
    """Gadget-RLWE encryption: value.q int64[beta, 2, LQ, N] (+ P part).

    Row (d, 0) = -a_d·s + e_d + m·g_d, row (d, 1) = a_d, NTT + Montgomery.
    """

    value: QPPoly


@dataclass
class RelinearizationKey:
    """Evaluation key for s² → s."""

    gadget: GadgetCiphertext


@dataclass
class EvaluationKeySet:
    """In-memory evaluation-key set (relinearization only in this port)."""

    relinearization_key: RelinearizationKey | None = None


class KeyGenerator:
    def __init__(self, params: Parameters):
        self.params = params

    def gen_secret_key(self, gen: torch.Generator, dist=None) -> SecretKey:
        """Sample sk from params.xs, or an explicit distribution."""
        p = self.params
        x = sampling.signed(gen, p.n, p.xs if dist is None else dist)
        return self.secret_key_from_signed(x)

    def secret_key_from_signed(self, x) -> SecretKey:
        """Encode explicit signed coefficients (int64[N]) as a SecretKey."""
        rqp = self.params.ring_qp
        return SecretKey(rqp.mform(rqp.ntt(rqp.lift_signed(x))))

    def _gadget_scalars(self, level_q: int) -> torch.Tensor:
        """MForm(P mod q_j) per Q row, int64[level_q+1, 1]."""
        p = self.params
        P = p.p_big_int() if p.ring_p is not None else 1
        return u64_tensor([_mform_int(P % q, q) for q in p.q_moduli[: level_q + 1]],
                          p.device, (level_q + 1, 1))

    def gadget_encrypt(self, gen: torch.Generator, m_q, sk_out: SecretKey,
                       level_q: int | None = None) -> GadgetCiphertext:
        """Gadget-encrypt m (Q part, NTT + Montgomery, int64[lq+1, N])."""
        p = self.params
        if p.ring_p is None:
            raise NotImplementedError(
                "RNS gadget encryption requires an auxiliary P basis")
        level_q = p.max_level if level_q is None else level_q
        alpha = len(p.p_moduli)
        lq = level_q + 1
        beta = -(-lq // alpha)
        gfac = self._gadget_scalars(level_q)
        rqp = p.ring_qp
        rq = p.ring_q
        sk_l = rqp.at_level(sk_out.value, level_q)
        rows = []
        for d in range(beta):
            a = rqp.uniform(gen, level_q)
            c1 = rqp.mform(a, level_q)
            a_s = rqp.mul_mont(a, sk_l, level_q)
            e = rqp.ntt(rqp.sample_signed(gen, p.xe, level_q), level_q)
            c0 = rqp.mform(rqp.sub(e, a_s, level_q), level_q)
            lo, hi = d * alpha, min((d + 1) * alpha, lq)
            # m·g_d on the digit's own rows (both operands M-form → M-form)
            term = modops.mred(m_q[..., lo:hi, :], gfac[lo:hi], rq.q[lo:hi],
                               rq.qinv[lo:hi], rq.small)
            c0q = c0.q.clone()
            c0q[..., lo:hi, :] = modops.add_mod(c0q[..., lo:hi, :], term,
                                                rq.q[lo:hi])
            rows.append(qp_stack([QPPoly(c0q, c0.p), c1]))
        return GadgetCiphertext(qp_stack(rows))

    def gen_relinearization_key(self, gen: torch.Generator,
                                sk: SecretKey) -> RelinearizationKey:
        """Gadget encryption of s² under s."""
        s2 = self.params.ring_q.mul_mont(sk.value.q, sk.value.q)
        return RelinearizationKey(self.gadget_encrypt(gen, s2, sk))
