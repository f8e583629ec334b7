"""Comparison circuits: sign, step, min and max on encrypted reals.

Counterpart of :mod:`lattigo_tpu.circuits.comparison` (ref
``circuits/ckks/comparison/comparison.go``). Sign is a minimax composite
polynomial evaluated stage by stage by
:class:`~lattigo_tpu_torch.circuits.minimax.MinimaxCompositeEvaluator`,
bootstrapping between stages when levels run short; the composite is the
host Remez generator's output plus X4 cleanup stages, the construction of
the reference's DefaultCompositePolynomialForSign. Without tables
(``sign_polys=None``) sign composes the CKK f₃ polynomial
(35x − 35x³ + 21x⁵ − 5x⁷)/16, good to about 20 bits.
"""

from __future__ import annotations

import functools
from fractions import Fraction

from lattigo_tpu_torch.circuits.minimax import SIGN_X4_CHEBY, MinimaxCompositeEvaluator
from lattigo_tpu_torch.circuits.polynomial import Polynomial, PolynomialEvaluator
from lattigo_tpu_torch.rlwe.elements import Ciphertext
from lattigo_tpu_torch.utils.minimax import gen_minimax_composite_sign

F3 = Polynomial([0.0, 35.0 / 16, 0.0, -35.0 / 16, 0.0, 21.0 / 16, 0.0, -5.0 / 16])


@functools.lru_cache(maxsize=None)
def default_composite_sign_polys(alpha: int = 12,
                                 degrees: tuple[int, ...] = (15, 15, 17, 31),
                                 x4_stages: int = 1) -> tuple[Polynomial, ...]:
    """Remez composite for sign on ±[2^-alpha, 1] with ``x4_stages``
    trailing X4 cleanup stages. The defaults are the JAX package's; with
    them the generator raises (stage 1 cannot contract the band), as it
    does there."""
    polys = gen_minimax_composite_sign(alpha, list(degrees))
    return tuple(polys + [SIGN_X4_CHEBY] * x4_stages)


class ComparisonEvaluator:
    """ref circuits/ckks/comparison/comparison.go:16."""

    def __init__(self, ckks_eval, iterations: int = 3,
                 sign_polys: list[Polynomial] | None = None,
                 bootstrapper=None):
        self.ev = ckks_eval
        self.poly_eval = PolynomialEvaluator(ckks_eval)
        self.minimax = MinimaxCompositeEvaluator(ckks_eval, bootstrapper)
        self.iterations = iterations
        self.sign_polys = sign_polys

    def sign(self, ct: Ciphertext) -> Ciphertext:
        """sign(x) for slots in [−1, −ε] ∪ [ε, 1]."""
        if self.sign_polys is not None:
            return self.minimax.evaluate(ct, self.sign_polys)
        out = ct
        for _ in range(self.iterations):
            out = self.poly_eval.evaluate(out, F3)
        return out

    def step(self, ct: Ciphertext) -> Ciphertext:
        """(sign(x)+1)/2 ∈ {0, 1}. With minimax tables the map (x+1)/2 is
        folded into the last stage (halved coefficients, an exact 1/2 added
        to the constant), which saves the level a separate halving costs."""
        if self.sign_polys is not None:
            last = self.sign_polys[-1]
            coeffs = [c / 2 for c in last.coeffs]
            coeffs[0] = coeffs[0] + Fraction(1, 2)
            folded = Polynomial(coeffs, basis=last.basis, interval=last.interval)
            return self.minimax.evaluate(ct, list(self.sign_polys[:-1]) + [folded])
        ev = self.ev
        half = ev.rescale(ev.mul_const(self.sign(ct), 0.5))
        return ev.add(half, 0.5)

    def _sign_product(self, a: Ciphertext, b: Ciphertext):
        """((a+b)/2, sign(a−b)·(a−b)/2), shared by min and max."""
        ev = self.ev
        diff = ev.sub(a, b)
        s = self.sign(diff)
        avg = ev.rescale(ev.mul_const(ev.add(a, b), 0.5))
        half_diff = ev.rescale(ev.mul_const(diff, 0.5))
        lvl = min(half_diff.level, s.level)
        prod = ev.rescale(ev.mul_relin(half_diff.at_level(lvl), s.at_level(lvl)))
        lvl = min(avg.level, prod.level)
        return avg.at_level(lvl), prod.at_level(lvl)

    def max(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """max(a, b) = (a+b)/2 + |a−b|/2."""
        avg, prod = self._sign_product(a, b)
        return self.ev.add(avg, prod)

    def min(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """min(a, b) = (a+b)/2 − |a−b|/2."""
        avg, prod = self._sign_product(a, b)
        return self.ev.sub(avg, prod)
