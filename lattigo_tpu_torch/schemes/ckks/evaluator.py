"""CKKS evaluator: approximate arithmetic with exact scale bookkeeping.

Counterpart of :mod:`lattigo_tpu.schemes.ckks.evaluator`. Scales are
exact Fractions kept on the host beside the residue tensors; no scale
arithmetic happens on the device.

Scale policy (the reference's):

* add/sub: the smaller-scale operand is multiplied by the ROUNDED integer
  ratio of the two scales and relabelled to the larger one (flooring would
  multiply by 1023 where planned scales land just below 1024);
* mul: out.scale = s0·s1;
* rescale: drop q_l, scale /= q_l.

Every op broadcasts over leading batch axes.
"""

from __future__ import annotations

from fractions import Fraction

import torch

from lattigo_tpu_torch.ring import modops, scaling
from lattigo_tpu_torch.rlwe.elements import (
    Ciphertext, Plaintext, ciphertext_from_polys,
)
from lattigo_tpu_torch.rlwe.evaluator import Evaluator as RlweEvaluator
from lattigo_tpu_torch.rlwe.keys import EvaluationKeySet
from lattigo_tpu_torch.schemes.ckks.params import Parameters
from lattigo_tpu_torch.trace import span


def _quantise(c, scale: Fraction) -> tuple[int, int]:
    """(re, im) of c·scale rounded to integers: a complex constant through
    f64, a real one exactly (Fraction, int and float are exact rationals)."""
    if isinstance(c, complex):
        return int(round(c.real * float(scale))), int(round(c.imag * float(scale)))
    return round(Fraction(c) * scale), 0


class Evaluator(RlweEvaluator):
    def __init__(self, params: Parameters, evk: EvaluationKeySet | None = None):
        super().__init__(params, evk)
        self.params: Parameters = params
        self._i_monomials: dict[int, torch.Tensor] = {}

    # -- scale management -------------------------------------------------------

    def _match_scales(self, ct0: Ciphertext, ct1: Ciphertext):
        """Bring both operands to the larger scale: the smaller is multiplied
        by round(s_big/s_small) and relabelled to s_big; the residual
        relative mismatch folds into the message error. A mismatch past 1 %
        is a circuit bug and raises."""
        s0, s1 = Fraction(ct0.scale), Fraction(ct1.scale)
        if s0 == s1:
            return ct0, ct1
        if s1 < s0:
            ct1m, ct0m = self._match_scales(ct1, ct0)
            return ct0m, ct1m
        ri = int(s1 / s0 + Fraction(1, 2))
        if ri > 1:
            v = self.params.ring_q.mul_scalar(ct0.value, ri, ct0.level)
            ct0 = ct0.replace(value=v, scale=s0 * ri)
            s0 = s0 * ri
        rel = float(s1 / s0)
        if not 0.99 < rel < 1.01:
            raise ValueError(f"scale mismatch too large to fold: {s0} vs {s1}")
        return ct0.replace(scale=s1), ct1

    def _match_pt_scale(self, ct: Ciphertext, pt: Plaintext):
        s0, s1 = Fraction(ct.scale), Fraction(pt.scale)
        if s0 == s1:
            return ct, pt
        rq = self.params.ring_q
        if s1 > s0:
            ri = int(s1 / s0 + Fraction(1, 2))
            if ri > 1:
                ct = ct.replace(value=rq.mul_scalar(ct.value, ri, ct.level),
                                scale=s0 * ri)
                s0 = s0 * ri
        else:
            ri = int(s0 / s1 + Fraction(1, 2))
            if ri > 1:
                pt = pt.replace(value=rq.mul_scalar(pt.value, ri, pt.level),
                                scale=s1 * ri)
                s1 = s1 * ri
        rel = float(max(s0, s1) / min(s0, s1))
        if not 0.99 < rel < 1.01:
            raise ValueError(f"ct/pt scale mismatch too large to fold: {s0} vs {s1}")
        hi = max(s0, s1)
        return ct.replace(scale=hi), pt.replace(scale=hi)

    # -- linear ops ---------------------------------------------------------------

    def _linear(self, ct0: Ciphertext, op1, negate: bool) -> Ciphertext:
        rq = self.params.ring_q
        op = rq.sub if negate else rq.add
        if isinstance(op1, Ciphertext):
            ct0, ct1 = self._match_scales(ct0, op1)
            level = min(ct0.level, ct1.level)
            d = max(ct0.degree, ct1.degree)
            return ct0.replace(value=op(self._resize(ct0, d, level),
                                        self._resize(ct1, d, level), level))
        if isinstance(op1, Plaintext):
            ct0, pt = self._match_pt_scale(ct0, op1)
            level = min(ct0.level, pt.level)
            v = ct0.value[..., : level + 1, :].clone()
            v[..., 0, :, :] = op(v[..., 0, :, :], pt.value[..., : level + 1, :], level)
            return ct0.replace(value=v)
        return self._add_const(ct0, op1, negate)

    def add(self, ct0: Ciphertext, op1) -> Ciphertext:
        """ct0 + op1 for a ciphertext, a plaintext or a real/complex constant."""
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

    def _monomial_poly(self, c0: int, c_half: int, level: int):
        """NTT of c0 + c_half·X^{N/2} over limbs 0..level, int64[l+1, N]."""
        rq = self.params.ring_q
        poly = torch.zeros((level + 1, rq.n), dtype=torch.int64, device=rq.device)
        poly[:, :1] = rq.rns_scalar(c0, level, mont=False)
        poly[:, rq.n // 2: rq.n // 2 + 1] = rq.rns_scalar(c_half, level, mont=False)
        return rq.ntt(poly, level)

    def _add_const(self, ct: Ciphertext, c, negate: bool) -> Ciphertext:
        """ct ± c for a real/complex constant encoded at ct.scale: the real
        part adds to the constant coefficient, the imaginary part rides on
        X^{N/2}, which is i in every slot (5^j ≡ 1 mod 4)."""
        level = ct.level
        cre, cim = _quantise(c, Fraction(ct.scale))
        if negate:
            cre, cim = -cre, -cim
        poly = self._monomial_poly(cre, cim, level)
        v = ct.value.clone()
        v[..., 0, :, :] = self.params.ring_q.add(v[..., 0, :, :], poly, level)
        return ct.replace(value=v)

    def mul_scalar_int(self, ct: Ciphertext, k: int) -> Ciphertext:
        """Exact integer scalar multiply (scale unchanged)."""
        return ct.replace(value=self.params.ring_q.mul_scalar(ct.value, k, ct.level))

    def scale_up(self, ct: Ciphertext, factor: int) -> Ciphertext:
        """Multiply value AND scale by an integer: the message is unchanged,
        the scale grows."""
        factor = int(factor)
        return ct.replace(
            value=self.params.ring_q.mul_scalar(ct.value, factor, ct.level),
            scale=Fraction(ct.scale) * factor)

    def set_scale(self, ct: Ciphertext, scale) -> Ciphertext:
        """Bring the ciphertext to exactly ``scale``: one constant mul at the
        quantised ratio, then a rescale; the quantisation error becomes
        noise."""
        scale = Fraction(scale)
        q_l = Fraction(self.params.q_moduli[ct.level])
        r = round(scale * q_l / Fraction(ct.scale))
        out = self.rescale(ct.replace(
            value=self.params.ring_q.mul_scalar(ct.value, r, ct.level),
            scale=Fraction(ct.scale) * r))
        return out.replace(scale=scale)

    def mul_const(self, ct: Ciphertext, c,
                  const_scale: Fraction | None = None) -> Ciphertext:
        """Multiply by a real/complex constant quantised at ``const_scale``
        (default q_level, so one rescale restores the input scale). The
        imaginary part multiplies by cim·X^{N/2}, a product with the NTT of
        that monomial."""
        p = self.params
        rq = p.ring_q
        level = ct.level
        cs = Fraction(p.q_moduli[level]) if const_scale is None else Fraction(const_scale)
        cre, cim = _quantise(c, cs)
        out = rq.mul_scalar(ct.value, cre, level)
        if cim:
            poly = rq.mform(self._monomial_poly(0, cim, level), level)
            out = rq.add(out, rq.mul_mont(ct.value, poly, level), level)
        return ct.replace(value=out, scale=Fraction(ct.scale) * cs)

    # -- multiplication -------------------------------------------------------------

    def mul(self, ct0: Ciphertext, op1, relin: bool = False) -> Ciphertext:
        """Tensor product ct0 ⊗ op1 (a ciphertext or a plaintext),
        optionally relinearized; scale s0·s1."""
        rq = self.params.ring_q
        sm = rq.small
        if isinstance(op1, Plaintext):
            level = min(ct0.level, op1.level)
            l = level + 1
            with span("ckks.mul"):
                ptm = rq.mform(op1.value[..., :l, :], level)
                v = modops.mred(ct0.value[..., :l, :], ptm[..., None, :, :],
                                rq.q[:l], rq.qinv[:l], sm)
            return ct0.replace(value=v,
                               scale=Fraction(ct0.scale) * Fraction(op1.scale))
        ct1: Ciphertext = op1
        if ct0.degree != 1 or ct1.degree != 1:
            raise ValueError("mul expects degree-1 inputs")
        level = min(ct0.level, ct1.level)
        l = level + 1
        q, qinv = rq.q[:l], rq.qinv[:l]
        am = rq.mform(ct0.value[..., :l, :], level)
        b = ct1.value[..., :l, :]
        a0, a1 = am[..., 0, :, :], am[..., 1, :, :]
        b0, b1 = b[..., 0, :, :], b[..., 1, :, :]
        c0 = modops.mred(a0, b0, q, qinv, sm)
        c1 = modops.add_mod(modops.mred(a0, b1, q, qinv, sm),
                            modops.mred(a1, b0, q, qinv, sm), q)
        c2 = modops.mred(a1, b1, q, qinv, sm)
        out = ciphertext_from_polys(
            [c0, c1, c2], is_ntt=True,
            scale=Fraction(ct0.scale) * Fraction(ct1.scale))
        return self.relinearize(out) if relin else out

    def mul_relin(self, ct0: Ciphertext, op1) -> Ciphertext:
        with span("ckks.mul_relin"):
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

    # -- rescaling ------------------------------------------------------------------

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """Divide by q_level (rounded) and drop it; scale /= q_level."""
        p = self.params
        level = ct.level
        if level < 1:
            raise ValueError("cannot rescale at level 0")
        with span("ckks.rescale"):
            v = scaling.div_by_last_modulus(p.ring_q, ct.value, level,
                                            ntt_domain=ct.is_ntt, round_div=True)
        return ct.replace(value=v,
                          scale=Fraction(ct.scale) / Fraction(p.q_moduli[level]))

    def rescale_to(self, ct: Ciphertext, target: Fraction) -> Ciphertext:
        """Rescale while scale / q_l stays ≥ target."""
        while (ct.level > 0 and Fraction(ct.scale)
               / self.params.q_moduli[ct.level] >= target):
            ct = self.rescale(ct)
        return ct

    # -- monomial tricks ------------------------------------------------------------

    def _i_monomial(self, level: int):
        """MForm(NTT(X^{N/2})) over limbs 0..level: X^{N/2} = i in every slot."""
        if level not in self._i_monomials:
            rq = self.params.ring_q
            self._i_monomials[level] = rq.mform(self._monomial_poly(0, 1, level), level)
        return self._i_monomials[level]

    def mul_by_i(self, ct: Ciphertext) -> Ciphertext:
        """Multiply all slots by i: exact, depth-free, scale-preserving."""
        level = ct.level
        return ct.replace(value=self.params.ring_q.mul_mont(
            ct.value, self._i_monomial(level), level))

    def mul_by_minus_i(self, ct: Ciphertext) -> Ciphertext:
        """Multiply all slots by −i (X^{3N/2} = −X^{N/2})."""
        rq = self.params.ring_q
        level = ct.level
        return ct.replace(value=rq.neg(rq.mul_mont(
            ct.value, self._i_monomial(level), level), level))

    # -- rotations ------------------------------------------------------------------

    def rotate(self, ct: Ciphertext, k: int) -> Ciphertext:
        """Cyclic left rotation of the N/2 slots by k."""
        return self.automorphism(ct, self.params.galois_element(k))

    def conjugate(self, ct: Ciphertext) -> Ciphertext:
        """Slot-wise complex conjugation."""
        return self.automorphism(ct, self.params.galois_element_order_two)

    def rotate_hoisted(self, ct: Ciphertext, ks: list[int]) -> dict:
        """{k: rot(ct, k)} from ONE gadget decomposition of c1."""
        if ct.degree != 1 or not ct.is_ntt:
            raise ValueError("rotate_hoisted takes a degree-1 NTT ciphertext")
        digits = self.decompose_ntt(ct.value[..., 1, :, :], ct.level)
        return {k: (ct if k == 0 else self.automorphism_hoisted(
            ct, digits, self.params.galois_element(k))) for k in ks}

    def rotate_and_add(self, ct: Ciphertext, batch: int, n: int) -> Ciphertext:
        """Σ_{i<n} rot(ct, i·batch), the log-depth ladder of inner_sum."""
        return self.inner_sum(ct, batch, n)
