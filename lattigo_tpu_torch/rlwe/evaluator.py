"""Scheme-generic RLWE evaluator: gadget product and relinearization.

Counterpart of the key-switching half of :mod:`lattigo_tpu.rlwe.evaluator`.
The gadget product is a digit-unrolled Montgomery MAC over NTT-domain QP
tensors, reduced lazily (a flush every ``margin`` terms, with the margin
derived from 2^63), ending in one ModDown by P. The decomposition is
hoistable: :meth:`Evaluator.decompose_ntt` returns the digit tensor once.
"""

from __future__ import annotations

import torch

from lattigo_tpu_torch.ring import modops
from lattigo_tpu_torch.ring.ringqp import QPPoly
from lattigo_tpu_torch.rlwe.elements import Ciphertext
from lattigo_tpu_torch.rlwe.keys import (
    EvaluationKeySet, GadgetCiphertext, RelinearizationKey,
)
from lattigo_tpu_torch.rlwe.params import Parameters


class Evaluator:
    """Shared key-switch machinery for scheme evaluators."""

    def __init__(self, params: Parameters, evk: EvaluationKeySet | None = None):
        self.params = params
        self.evk = evk or EvaluationKeySet()

    def decompose_ntt(self, c2_ntt, level_q: int) -> QPPoly:
        """RNS-decompose an NTT poly int64[..., lq+1, N] into QP-extended
        digits: q [..., beta, lq+1, N], p [..., beta, LP, N], NTT plain."""
        p = self.params
        coeff = p.ring_q.intt(c2_ntt, level_q)
        yq, yp = p.decomposer.decompose_all(coeff, level_q)
        return QPPoly(p.ring_q.ntt(yq, level_q), p.ring_p.ntt(yp))

    def gadget_product_hoisted_lazy(self, digits: QPPoly,
                                    gadget: GadgetCiphertext,
                                    level_q: int) -> QPPoly:
        """MAC digits against the gadget rows: QP [..., 2, lq+1 | LP, N],
        NTT plain, in [0, q)."""
        p = self.params
        rq, rp = p.ring_q, p.ring_p
        lq = level_q + 1
        beta = digits.q.shape[-3]
        evq = gadget.value.q
        evp = gadget.value.p
        if evq.shape[-2] < lq or evq.shape[-4] < beta:
            raise ValueError(f"evaluation key generated at level "
                             f"{evq.shape[-2] - 1} used at level {level_q}")
        margin = modops.margin_for(max(max(p.q_moduli[:lq]), max(p.p_moduli)))
        tq = modops.mred_lazy(digits.q[..., :, None, :, :], evq[:beta, :, :lq, :],
                              rq.q[:lq], rq.qinv[:lq], rq.small)
        tp = modops.mred_lazy(digits.p[..., :, None, :, :], evp[:beta],
                              rp.q, rp.qinv, rp.small)
        acc_q = modops.lazy_tree_sum(torch.movedim(tq, -4, 0), rq.q[:lq],
                                     rq.bred_hi[:lq], margin)
        acc_p = modops.lazy_tree_sum(torch.movedim(tp, -4, 0), rp.q,
                                     rp.bred_hi, margin)
        return QPPoly(modops.bred_add(acc_q, rq.q[:lq], rq.bred_hi[:lq]),
                      modops.bred_add(acc_p, rp.q, rp.bred_hi))

    def gadget_product_hoisted(self, digits: QPPoly, gadget: GadgetCiphertext,
                               level_q: int):
        """Hoisted gadget product ending in ModDown: int64[..., 2, lq+1, N]."""
        acc = self.gadget_product_hoisted_lazy(digits, gadget, level_q)
        return self.params.basis_extender.mod_down_qp_to_q(
            acc.q, acc.p, level_q, ntt_domain=True)

    def gadget_product(self, c2_ntt, gadget: GadgetCiphertext, level_q: int):
        """(d0, d1) ← c2 ⊛ gadget: int64[..., lq+1, N] → [..., 2, lq+1, N]."""
        return self.gadget_product_hoisted(
            self.decompose_ntt(c2_ntt, level_q), gadget, level_q)

    def relinearize(self, ct: Ciphertext,
                    rlk: RelinearizationKey | None = None) -> Ciphertext:
        """Degree-d → degree-1 by iterated key switching."""
        rlk = rlk if rlk is not None else self.evk.relinearization_key
        if rlk is None:
            raise ValueError("relinearize needs a relinearization key")
        if not ct.is_ntt:
            raise ValueError("relinearize expects NTT-domain ciphertexts")
        level = ct.level
        rq = self.params.ring_q
        v = ct.value
        while v.shape[-3] > 2:
            d = self.gadget_product(v[..., -1, :, :], rlk.gadget, level)
            v = torch.stack([rq.add(v[..., 0, :, :], d[..., 0, :, :], level),
                             rq.add(v[..., 1, :, :], d[..., 1, :, :], level)]
                            + [v[..., i, :, :] for i in range(2, v.shape[-3] - 1)],
                            dim=-3)
        return ct.replace(value=v)
