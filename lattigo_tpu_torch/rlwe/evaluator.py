"""Scheme-generic RLWE evaluator: gadget product, relinearization,
automorphisms, hoisted rotations, trace and inner sums.

Counterpart of :mod:`lattigo_tpu.rlwe.evaluator`.
The gadget product is a digit-unrolled Montgomery MAC over NTT-domain QP
tensors, reduced lazily (a flush every ``margin`` terms, with the margin
derived from 2^63), ending in one ModDown by P. The decomposition is
hoistable: :meth:`Evaluator.decompose_ntt` returns the digit tensor once.
A power-of-two gadget (``gadget.base2`` > 0) takes
:meth:`Evaluator.gadget_product_base2` instead, with or without P.
"""

from __future__ import annotations

import torch

from lattigo_tpu_torch.ring import automorphism as auto_mod, modops
from lattigo_tpu_torch.ring.ring import STANDARD
from lattigo_tpu_torch.ring.ringqp import QPPoly
from lattigo_tpu_torch.rlwe.elements import Ciphertext
from lattigo_tpu_torch.rlwe.errors import MissingRelinearizationKeyError
from lattigo_tpu_torch.rlwe.keys import (
    EvaluationKeySet, GadgetCiphertext, RelinearizationKey,
)
from lattigo_tpu_torch.rlwe.params import Parameters
from lattigo_tpu_torch.trace import span


class Evaluator:
    """Shared key-switch machinery for scheme evaluators."""

    def __init__(self, params: Parameters, evk: EvaluationKeySet | None = None):
        self.params = params
        self.evk = evk or EvaluationKeySet()

    def decompose_ntt(self, c2_ntt, level_q: int) -> QPPoly:
        """RNS-decompose an NTT poly int64[..., lq+1, N] into QP-extended
        digits: q [..., beta, lq+1, N], p [..., beta, LP, N], NTT plain."""
        p = self.params
        with span("ks.modup"):
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
        with span("ks.mac"):
            return QPPoly(
                modops.mred_sum(digits.q[..., :, None, :, :], evq[:beta, :, :lq, :],
                                rq.q[:lq], rq.qinv[:lq], rq.bred_hi[:lq], margin,
                                rq.small),
                modops.mred_sum(digits.p[..., :, None, :, :], evp[:beta], rp.q,
                                rp.qinv, rp.bred_hi, margin, rp.small))

    def gadget_product_hoisted(self, digits: QPPoly, gadget: GadgetCiphertext,
                               level_q: int):
        """Hoisted gadget product ending in ModDown: int64[..., 2, lq+1, N]."""
        acc = self.gadget_product_hoisted_lazy(digits, gadget, level_q)
        return self.params.basis_extender.mod_down_qp_to_q(
            acc.q, acc.p, level_q, ntt_domain=True)

    def gadget_product_base2(self, c2_ntt, gadget: GadgetCiphertext,
                             level_q: int):
        """Power-of-two gadget product: the digits are w-bit slices of each
        limb's canonical coefficients, lifted to every limb as they are
        (a digit < 2^w < q), NTT'd in one batched call per ring and MAC'd
        against the (limb, digit) rows; the rows are summed lazily with a
        Barrett fold before 2^63 (61-bit primes pass it after a few rows),
        then ModDown by P when the gadget has a P part. A key made at a
        higher level is sliced to ``level_q``'s limbs and rows."""
        p = self.params
        rq = p.ring_q
        lq = level_q + 1
        w = gadget.base2
        evq, evp = gadget.value.q, gadget.value.p   # [rows, 2, LQ | LP, N]
        if evq.shape[-2] < lq:
            raise ValueError(f"evaluation key generated at level "
                             f"{evq.shape[-2] - 1} used at level {level_q}")
        max_dig = evq.shape[-4] // evq.shape[-2]
        rows = lq * max_dig
        with span("ks.modup"):
            cx = rq.intt(c2_ntt, level_q)            # canonical, < 2^61
            shifts = torch.arange(max_dig, device=cx.device) * w
            digits = (cx[..., :, None, :] >> shifts[:, None]) & ((1 << w) - 1)
            dflat = digits.reshape(digits.shape[:-3] + (rows, 1, digits.shape[-1]))
        moduli = p.q_moduli[:lq] + p.p_moduli
        margin = modops.margin_for(max(moduli))

        def mac(ring, ev, limbs: int):
            """Σ_r NTT(digit_r) · ev_r over the ring's first ``limbs``."""
            q, bhi = ring.q[:limbs], ring.bred_hi[:limbs]
            with span("ks.mac"):
                d = ring.ntt(dflat.expand(dflat.shape[:-2] + (limbs, dflat.shape[-1])),
                             limbs - 1)
                t = modops.mred_lazy(d[..., :, None, :, :], ev, q, ring.qinv[:limbs],
                                     ring.small)
                acc = modops.lazy_tree_sum(torch.movedim(t, -4, 0), q, bhi, margin)
                return modops.bred_add(acc, q, bhi)

        acc_q = mac(rq, evq[:rows, :, :lq, :], lq)
        if evp is None:
            return acc_q
        acc_p = mac(p.ring_p, evp[:rows], len(p.p_moduli))
        return p.basis_extender.mod_down_qp_to_q(acc_q, acc_p, level_q,
                                                 ntt_domain=True)

    def gadget_product(self, c2_ntt, gadget: GadgetCiphertext, level_q: int):
        """(d0, d1) ← c2 ⊛ gadget: int64[..., lq+1, N] → [..., 2, lq+1, N]."""
        if gadget.base2:
            return self.gadget_product_base2(c2_ntt, gadget, level_q)
        return self.gadget_product_hoisted(
            self.decompose_ntt(c2_ntt, level_q), gadget, level_q)

    def relinearize(self, ct: Ciphertext,
                    rlk: RelinearizationKey | None = None) -> Ciphertext:
        """Degree-d → degree-1 by iterated key switching."""
        rlk = rlk if rlk is not None else self.evk.relinearization_key
        if rlk is None:
            raise MissingRelinearizationKeyError()
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

    def apply_evaluation_key(self, ct: Ciphertext, evk) -> Ciphertext:
        """Re-encrypt a degree-1 NTT ciphertext under the key ``evk`` (an
        evaluation key or its gadget) switches to."""
        if ct.degree != 1 or not ct.is_ntt:
            raise ValueError("apply_evaluation_key takes a degree-1 NTT ciphertext")
        level = ct.level
        gadget = evk.gadget if hasattr(evk, "gadget") else evk
        d = self.gadget_product(ct.value[..., 1, :, :], gadget, level)
        d0 = self.params.ring_q.add(d[..., 0, :, :], ct.value[..., 0, :, :], level)
        return ct.replace(value=torch.stack([d0, d[..., 1, :, :]], dim=-3))

    def automorphism(self, ct: Ciphertext, gal_el: int) -> Ciphertext:
        """σ_{gal_el}(ct): key-switch c1, then permute in the NTT domain."""
        if gal_el == 1:
            return ct
        ks = self.apply_evaluation_key(ct, self.evk.galois_key(gal_el))
        return ks.replace(value=auto_mod.automorphism_ntt(
            ks.value, self.params.n, gal_el, self.params.ring_type))

    def automorphism_hoisted(self, ct: Ciphertext, digits: QPPoly,
                             gal_el: int) -> Ciphertext:
        """σ_{gal_el}(ct) from a precomputed decomposition of c1
        (:meth:`decompose_ntt`)."""
        if gal_el == 1:
            return ct
        gk = self.evk.galois_key(gal_el)
        level = ct.level
        d = self.gadget_product_hoisted(digits, gk.gadget, level)
        d0 = self.params.ring_q.add(d[..., 0, :, :], ct.value[..., 0, :, :], level)
        v = torch.stack([d0, d[..., 1, :, :]], dim=-3)
        return ct.replace(value=auto_mod.automorphism_ntt(
            v, self.params.n, gal_el, self.params.ring_type))

    def rotate_columns(self, ct: Ciphertext, k: int) -> Ciphertext:
        return self.automorphism(ct, self.params.galois_element(k))

    def rotate_columns_hoisted(self, ct: Ciphertext,
                               ks: list[int]) -> dict[int, Ciphertext]:
        """Rotate by every k in ks from ONE gadget decomposition of c1: the
        INTT + ModUp + NTT of the decomposition is paid once."""
        digits = self.decompose_ntt(ct.value[..., 1, :, :], ct.level)
        return {k: self.automorphism_hoisted(
            ct, digits, self.params.galois_element(k)) for k in ks}

    # -- trace / inner sum ---------------------------------------------------

    def trace(self, ct: Ciphertext, log_n_start: int) -> Ciphertext:
        """Trace onto the degree-2^logn sub-ring: multiply by (N/n)^{-1},
        then the ladder out ← out + σ_{5^{2^i}}(out), plus the order-two
        element when logn == 0 on the standard ring (on the
        conjugate-invariant ring it is the identity)."""
        p = self.params
        level = ct.level
        gap = 1 << (p.log_n - log_n_start - 1)
        if log_n_start == 0:
            gap <<= 1
        if gap <= 1:
            return ct
        inv = pow(gap, -1, p.q_big_int(level))
        out = ct.replace(value=p.ring_q.mul_scalar(ct.value, inv, level))
        for gal_el in self.galois_elements_for_trace(log_n_start):
            rot = self.automorphism(out, gal_el)
            out = out.replace(value=p.ring_q.add(out.value, rot.value, level))
        return out

    def galois_elements_for_trace(self, log_n_start: int) -> list[int]:
        """Galois keys :meth:`trace` needs, in the order it applies them."""
        p = self.params
        els = [p.galois_element(1 << i) for i in range(log_n_start, p.log_n - 1)]
        if log_n_start == 0 and p.ring_type == STANDARD:
            els.append(p.galois_element_order_two)
        return els

    def inner_function(self, ct: Ciphertext, batch: int, n: int,
                       f) -> Ciphertext:
        """Log-depth rotate-and-combine: the ``f``-fold of rot(ct, i·batch)
        for i < n. Doubling ladders build the fold over 2^j elements, and
        each set bit of n adds its ladder rotated past the lower blocks."""
        acc = None
        cur = ct          # fold over {rot(ct, i·batch) : i < m}
        m = 1
        pos = 0           # Σ of lower set bits (block offset)
        while m <= n:
            if n & m:
                part = cur if pos == 0 else self.rotate_columns(cur, pos * batch)
                acc = part if acc is None else f(acc, part)
                pos += m
            m <<= 1
            if m <= n:
                cur = f(cur, self.rotate_columns(cur, (m >> 1) * batch))
        return acc

    def partial_traces_sum(self, ct: Ciphertext, offset: int,
                           n: int) -> Ciphertext:
        """Σ_{i<n} φ_{i·offset}(ct) from ONE gadget decomposition of c1: the
        hoisted linear-depth alternative to :meth:`inner_sum`."""
        if offset == 0:
            raise ValueError("partial_traces_sum: offset must be non-zero")
        if n == 1:
            return ct
        p = self.params
        level = ct.level
        digits = self.decompose_ntt(ct.value[..., 1, :, :], level)
        acc = ct.value
        for gal_el in self.galois_elements_for_partial_traces_sum(offset, n):
            rot = self.automorphism_hoisted(ct, digits, gal_el)
            acc = p.ring_q.add(acc, rot.value, level)
        return ct.replace(value=acc)

    def galois_elements_for_partial_traces_sum(self, offset: int,
                                               n: int) -> list[int]:
        return [self.params.galois_element(i * offset) for i in range(1, n)]

    def inner_sum(self, ct: Ciphertext, batch: int, n: int) -> Ciphertext:
        """Σ_{i<n} rot(ct, i·batch), log depth, any n."""
        rq = self.params.ring_q

        def add(a: Ciphertext, b: Ciphertext) -> Ciphertext:
            return a.replace(value=rq.add(a.value, b.value, a.level))

        return self.inner_function(ct, batch, n, add)

    def replicate(self, ct: Ciphertext, batch: int, n: int) -> Ciphertext:
        """Replicate each batch block n times leftward (inner_sum with the
        opposite rotation direction)."""
        return self.inner_sum(ct, -batch, n)

    def galois_elements_for_inner_sum(self, batch: int, n: int) -> list[int]:
        """Galois keys :meth:`inner_sum` needs."""
        p = self.params
        els = set()
        m = 1
        pos = 0
        while m <= n:
            if n & m:
                if pos != 0:
                    els.add(p.galois_element(pos * batch))
                pos += m
            m <<= 1
            if m <= n:
                els.add(p.galois_element((m >> 1) * batch))
        return sorted(els)
