"""Minimax composite polynomial evaluator.

Counterpart of :mod:`lattigo_tpu.circuits.minimax` (ref
``circuits/ckks/minimax``, minimax_composite_polynomial_evaluator.go:15):
evaluates P(x) = p_k ∘ … ∘ p_1(x) stage by stage, bootstrapping before a
stage whenever the remaining levels cannot cover its depth (planned by
:func:`~lattigo_tpu_torch.circuits.polynomial.simulate`), and on the
standard ring cleaning the imaginary part after every stage: the stage is
evaluated at half the target scale, relabelled at exactly twice it, and
its conjugate added.

The stages come from the host Remez generator
(:func:`lattigo_tpu_torch.utils.minimax.gen_minimax_composite_sign`) or
from the published X2/X4 precision-doubling cleanup polynomials of
ia.cr/2019/1234 (ref CoeffsSignX2Cheby / CoeffsSignX4Cheby).
"""

from __future__ import annotations

from fractions import Fraction

from lattigo_tpu_torch.circuits.polynomial import (
    CHEBYSHEV,
    Polynomial,
    PolynomialEvaluator,
    simulate,
)
from lattigo_tpu_torch.ring.ring import STANDARD
from lattigo_tpu_torch.rlwe.elements import Ciphertext

# 1.5x − 0.5x³ in Chebyshev basis: about doubles the correct digits of
# values already close to ±1.
SIGN_X2_CHEBY = Polynomial(
    [0.0, 1.125, 0.0, -0.125], basis=CHEBYSHEV, interval=(-1.0, 1.0))

# (35x − 35x³ + 21x⁵ − 5x⁷)/16 in Chebyshev basis: about quadruples them.
SIGN_X4_CHEBY = Polynomial(
    [0.0, 1.1962890625, 0.0, -0.2392578125, 0.0, 0.0478515625, 0.0,
     -0.0048828125], basis=CHEBYSHEV, interval=(-1.0, 1.0))


class MinimaxCompositeEvaluator:
    """Stage-wise composite evaluation with bootstrapping between stages."""

    def __init__(self, ckks_eval, bootstrapper=None):
        self.ev = ckks_eval
        self.params = ckks_eval.params
        self.poly_eval = PolynomialEvaluator(ckks_eval)
        self.btp = bootstrapper

    def evaluate(self, ct: Ciphertext, mcp: list[Polynomial]) -> Ciphertext:
        """P(ct) for P = mcp[-1] ∘ … ∘ mcp[0]."""
        p = self.params
        standard = p.ring_type == STANDARD
        min_lvl = self.btp.minimum_input_level if self.btp is not None else 0

        res = ct
        for poly in mcp:
            # at Δ/2 on the standard ring, so that res + conj(res) lands at Δ
            target = (p.default_scale_fraction / 2 if standard
                      else p.default_scale_fraction)
            sim = simulate(p, p.max_level, p.default_scale_fraction, poly, target)
            depth = p.max_level - sim.level
            if res.level < depth + min_lvl:
                if self.btp is None:
                    raise ValueError(
                        f"level {res.level} < stage depth {depth} and no "
                        "bootstrapper was provided")
                res = self.btp.bootstrap(res)
            res = self.poly_eval.evaluate(res, poly, target)
            if standard:
                # clean the imaginary part (it explodes under composition)
                res = res.replace(scale=Fraction(res.scale) * 2)
                res = self.ev.add(res, self.ev.conjugate(res))

        # the composite maps into [-1, 1]: restore the input's scale label
        return res.replace(scale=ct.scale)

    def galois_elements(self) -> list[int]:
        """Galois elements :meth:`evaluate` needs (conjugation only)."""
        if self.params.ring_type == STANDARD:
            return [self.params.galois_element_order_two]
        return []
