"""Unified BGV/BFV evaluator: add, sub, mul, mul_relin, rescale, rotations.

Counterpart of the BGV half of :mod:`lattigo_tpu.schemes.bgv.evaluator`.
Plaintexts are MSB-encoded as m·T^{-1} mod Q:

* add/sub require equal scales, matched by a scalar multiplication;
* tensoring multiplies the product by T once, keeping the m·T^{-1}
  invariant: (m1·s1/T)·(m2·s2/T)·T = m1m2·s1s2/T;
* rescale divides by q_l (rounded) with scale ← scale·q_l^{-1} mod T.

All ops broadcast over leading batch axes. BFV scale-invariant tensoring
(:meth:`Evaluator.mul_scale_invariant`) runs in the double basis Q ∪ QMul.
"""

from __future__ import annotations

import torch

from lattigo_tpu_torch.ring import modops, scaling
from lattigo_tpu_torch.ring.basis_extension import ModUpConstants, mod_up
from lattigo_tpu_torch.ring.ring import u64_tensor
from lattigo_tpu_torch.rlwe.elements import Ciphertext, Plaintext
from lattigo_tpu_torch.rlwe.evaluator import Evaluator as RlweEvaluator
from lattigo_tpu_torch.rlwe.keys import EvaluationKeySet
from lattigo_tpu_torch.schemes.bgv.params import Parameters


class Evaluator(RlweEvaluator):
    def __init__(self, params: Parameters, evk: EvaluationKeySet | None = None):
        super().__init__(params, evk)
        self.params: Parameters = params

    # -- scale management -------------------------------------------------------

    def match_scales(self, ct0: Ciphertext, ct1: Ciphertext):
        """Bring ct0 to ct1's scale by a scalar multiplication mod T."""
        p = self.params
        if ct0.scale == ct1.scale:
            return ct0, ct1
        r0 = ct1.scale * pow(ct0.scale, -1, p.t) % p.t
        v = p.ring_q.mul_scalar(ct0.value, r0, ct0.level)
        return ct0.replace(value=v, scale=ct1.scale), ct1

    # -- linear ops ---------------------------------------------------------------

    def _linear(self, ct0: Ciphertext, op1, negate: bool) -> Ciphertext:
        p = self.params
        rq = p.ring_q
        op = rq.sub if negate else rq.add
        if isinstance(op1, Ciphertext):
            ct0, ct1 = self.match_scales(ct0, op1)
            level = min(ct0.level, ct1.level)
            d = max(ct0.degree, ct1.degree)
            return ct0.replace(value=op(self._resize(ct0, d, level),
                                        self._resize(ct1, d, level), level))
        if isinstance(op1, Plaintext):
            level = min(ct0.level, op1.level)
            ptv = op1.value[..., : level + 1, :]
            if op1.scale != ct0.scale:
                r = ct0.scale * pow(op1.scale, -1, p.t) % p.t
                ptv = rq.mul_scalar(ptv, r, level)
            v = ct0.value[..., : level + 1, :].clone()
            v[..., 0, :, :] = op(v[..., 0, :, :], ptv, level)
            return ct0.replace(value=v)
        return self._add_scalar(ct0, int(op1), negate)

    def add(self, ct0: Ciphertext, op1) -> Ciphertext:
        return self._linear(ct0, op1, negate=False)

    def sub(self, ct0: Ciphertext, op1) -> Ciphertext:
        return self._linear(ct0, op1, negate=True)

    def neg(self, ct: Ciphertext) -> Ciphertext:
        return ct.replace(value=self.params.ring_q.neg(ct.value, ct.level))

    def _resize(self, ct: Ciphertext, degree: int, level: int):
        v = ct.value[..., : level + 1, :]
        if ct.degree < degree:
            pad = v.new_zeros(v.shape[:-3] + (degree - ct.degree,) + v.shape[-2:])
            v = torch.cat([v, pad], dim=-3)
        return v

    def _add_scalar(self, ct: Ciphertext, scalar: int, negate: bool) -> Ciphertext:
        """ct ± scalar, the constant lifted as scalar·scale·T^{-1} mod Q (a
        constant is the same value at every NTT evaluation point)."""
        p = self.params
        level = ct.level
        Q = p.q_big_int(level)
        c = scalar % p.t * ct.scale % p.t * pow(p.t, -1, Q) % Q
        const = p.ring_q.rns_scalar(c, level, mont=False)
        q = p.ring_q.q[: level + 1]
        v = ct.value.clone()
        v0 = v[..., 0, :, :]
        v[..., 0, :, :] = (modops.sub_mod(v0, const, q) if negate
                           else modops.add_mod(v0, const, q))
        return ct.replace(value=v)

    def mul_scalar(self, ct: Ciphertext, scalar: int) -> Ciphertext:
        p = self.params
        return ct.replace(value=p.ring_q.mul_scalar(ct.value, int(scalar) % p.t,
                                                    ct.level))

    # -- multiplication -----------------------------------------------------------

    def mul(self, ct0: Ciphertext, op1, relin: bool = False) -> Ciphertext:
        """BGV tensoring ct0 ⊗ op1 (·T), optionally relinearized."""
        p = self.params
        rq = p.ring_q
        sm = rq.small
        if isinstance(op1, Plaintext):
            level = min(ct0.level, op1.level)
            l = level + 1
            q, qinv = rq.q[:l], rq.qinv[:l]
            ptm = modops.mred(op1.value[..., :l, :], p.t_mont2[:l], q, qinv, sm)
            v = modops.mred(ct0.value[..., :l, :], ptm[..., None, :, :], q, qinv, sm)
            return ct0.replace(value=v, scale=p.scale_mul(ct0.scale, op1.scale))
        ct1: Ciphertext = op1
        if ct0.degree != 1 or ct1.degree != 1:
            raise ValueError("mul expects degree-1 inputs")
        level = min(ct0.level, ct1.level)
        l = level + 1
        q, qinv = rq.q[:l], rq.qinv[:l]
        v = self._tensor(ct0.value[..., :l, :], ct1.value[..., :l, :], q, qinv, sm,
                         lambda a: modops.mred(a, p.t_mont2[:l], q, qinv, sm))  # a·T
        out = Ciphertext(value=v, is_ntt=True, scale=p.scale_mul(ct0.scale, ct1.scale))
        return self.relinearize(out) if relin else out

    def mul_relin(self, ct0: Ciphertext, op1) -> Ciphertext:
        return self.mul(ct0, op1, relin=True)

    def mul_then_add(self, ct0: Ciphertext, op1, acc: Ciphertext) -> Ciphertext:
        """acc + ct0·op1."""
        return self.add(acc, self.mul(ct0, op1))

    def mul_relin_then_add(self, ct0: Ciphertext, op1,
                           acc: Ciphertext) -> Ciphertext:
        return self.add(acc, self.mul(ct0, op1, relin=True))

    def drop_level(self, ct: Ciphertext, levels: int = 1) -> Ciphertext:
        """Discard the top ``levels`` moduli without scaling."""
        return ct.at_level(ct.level - levels)

    # -- BFV scale-invariant tensoring --------------------------------------------

    def _qmul_tables(self, level: int):
        """Basis-conversion tables of the double basis at ``level``, built on
        first use: (Q → QMul, QMul → Q, Q^{-1} mod each QMul prime in
        M-form)."""
        cache = self.__dict__.setdefault("_qmul_cache", {})
        if level not in cache:
            p = self.params
            lq = level + 1
            qm = p.ring_qmul.moduli[:lq]
            q = p.q_moduli[:lq]
            big_q = p.q_big_int(level)
            dev = p.ring_q.device
            cache[level] = (
                ModUpConstants(q, qm, dev),
                ModUpConstants(qm, q, dev),
                u64_tensor([(pow(big_q % m, -1, m) << 64) % m for m in qm],
                           dev, (lq, 1)))
        return cache[level]

    @staticmethod
    def _tensor(a, b, q, qinv, small, mform):
        """(a0·b0, a0·b1 + a1·b0, a1·b1) of two degree-1 operands, a taken to
        M-form by ``mform`` first."""
        am = mform(a)
        a0, a1 = am[..., 0, :, :], am[..., 1, :, :]
        b0, b1 = b[..., 0, :, :], b[..., 1, :, :]
        c0 = modops.mred(a0, b0, q, qinv, small)
        c1 = modops.add_mod(modops.mred(a0, b1, q, qinv, small),
                            modops.mred(a1, b0, q, qinv, small), q)
        c2 = modops.mred(a1, b1, q, qinv, small)
        return torch.stack([c0, c1, c2], dim=-3)

    def mul_scale_invariant(self, ct0: Ciphertext, ct1: Ciphertext,
                            relin: bool = False) -> Ciphertext:
        """(ct0 ⊗ ct1)·(T/Q), the BFV tensoring: its noise does not grow
        with the operands' and no rescale is needed; the level is kept.

        Both operands are lifted to QMul (centered ModUp), tensored in Q and
        in QMul, and quantized: round(x/Q) mod QMul = (x_QMul − [x]_Q
        lifted)·Q^{-1}, brought back to Q (centered), times T."""
        p = self.params
        rq, rqm = p.ring_q, p.ring_qmul
        if ct0.degree != 1 or ct1.degree != 1:
            raise ValueError("mul_scale_invariant expects degree-1 inputs")
        level = min(ct0.level, ct1.level)
        l = level + 1
        q, qinv, q_bhi = rq.q[:l], rq.qinv[:l], rq.bred_hi[:l]
        qm_q, qm_qinv, qm_bhi = rqm.q[:l], rqm.qinv[:l], rqm.bred_hi[:l]
        up_c, back_c, qinv_qmul = self._qmul_tables(level)

        def to_qmul(x_ntt):
            ext = mod_up(rq.intt(x_ntt, level), up_c, qm_q, qm_qinv, qm_bhi,
                         centered=True)
            return rqm.ntt(ext, level)

        a_q = ct0.value[..., :l, :]
        b_q = ct1.value[..., :l, :]
        t_q = self._tensor(a_q, b_q, q, qinv, rq.small,
                           lambda x: rq.mform(x, level))
        t_m = self._tensor(to_qmul(a_q), to_qmul(b_q), qm_q, qm_qinv, rqm.small,
                           lambda x: modops.mform(x, qm_q, qm_bhi, rqm.bred_lo[:l]))

        # quantize: round(x/Q)·T back in basis Q
        lift = mod_up(rq.intt(t_q, level), up_c, qm_q, qm_qinv, qm_bhi,
                      centered=True)
        diff = modops.sub_mod(rqm.intt(t_m, level), lift, qm_q)
        rounded = modops.mred(diff, qinv_qmul, qm_q, qm_qinv, rqm.small)
        back = mod_up(rounded, back_c, q, qinv, q_bhi, centered=True)
        out_v = rq.ntt(rq.mul_scalar(back, p.t, level), level)

        q_mod_t_neg = (p.t - p.q_big_int(level) % p.t) % p.t
        scale = ct0.scale * ct1.scale % p.t * pow(q_mod_t_neg, -1, p.t) % p.t
        out = Ciphertext(value=out_v, is_ntt=True, scale=scale)
        return self.relinearize(out) if relin else out

    # -- rescaling ----------------------------------------------------------------

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """Divide by q_level, scale ← scale·q_l^{-1} mod T."""
        p = self.params
        level = ct.level
        if level < 1:
            raise ValueError("cannot rescale at level 0")
        v = scaling.div_by_last_modulus(p.ring_q, ct.value, level,
                                        ntt_domain=ct.is_ntt, round_div=True)
        return ct.replace(value=v, scale=p.scale_div_q(ct.scale, level))

    # -- rotations ----------------------------------------------------------------
    # rotate_columns (a cyclic rotation of both slot rows by k) is the RLWE
    # evaluator's.

    def rotate_rows(self, ct: Ciphertext) -> Ciphertext:
        """Swap the two slot rows (the order-two Galois element)."""
        return self.automorphism(ct, self.params.galois_element_order_two)

    def rotate_hoisted(self, ct: Ciphertext,
                       ks: list[int]) -> dict[int, Ciphertext]:
        """Column rotations by every k in ks from one shared decomposition."""
        return self.rotate_columns_hoisted(ct, ks)

    def rotate_and_add(self, ct: Ciphertext, batch: int, n: int) -> Ciphertext:
        """Σ_{i<n} rot(ct, i·batch), the log-depth ladder of inner_sum."""
        return self.inner_sum(ct, batch, n)
