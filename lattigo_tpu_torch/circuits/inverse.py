"""Homomorphic inverse 1/x.

Counterpart of :mod:`lattigo_tpu.circuits.inverse` (ref
``circuits/ckks/inverse/inverse.go``):

* :meth:`InverseEvaluator.goldschmidt_division`: iterative 1/x for
  x ∈ [2^{log2min}, 1], with the iteration count estimated from the scale
  when not given, and bootstraps between iterations;
* :meth:`InverseEvaluator.interval_normalization`: compresses
  [-2^{log2max}, 2^{log2max}] into [-1, 1] and tracks the encrypted
  normalization factor (modified Algorithm 2 of ia.cr/2022/280);
* :meth:`InverseEvaluator.evaluate_positive_domain`,
  :meth:`evaluate_negative_domain` and :meth:`evaluate_full_domain`: 1/x
  over [±2^{log2min}, ±2^{log2max}]; the full domain feeds |x| = x·sign(x)
  (a minimax composite sign) to Goldschmidt and multiplies the result by
  sign(x) again.
"""

from __future__ import annotations

import math
from fractions import Fraction

from lattigo_tpu_torch.circuits.minimax import MinimaxCompositeEvaluator
from lattigo_tpu_torch.circuits.polynomial import Polynomial
from lattigo_tpu_torch.rlwe.elements import Ciphertext


def _align(a: Ciphertext, b: Ciphertext):
    lvl = min(a.level, b.level)
    return a.at_level(lvl), b.at_level(lvl)


class InverseEvaluator:
    """ref circuits/ckks/inverse/inverse.go:18."""

    def __init__(self, ckks_eval, bootstrapper=None,
                 sign_polys: list[Polynomial] | None = None):
        self.ev = ckks_eval
        self.params = ckks_eval.params
        self.btp = bootstrapper
        self.minimax = MinimaxCompositeEvaluator(ckks_eval, bootstrapper)
        self.sign_polys = sign_polys

    def _maybe_bootstrap(self, ct: Ciphertext, need: int) -> Ciphertext:
        if self.btp is not None and ct.level < need:
            return self.btp.bootstrap(ct)
        return ct

    # -- Goldschmidt ------------------------------------------------------------

    def estimate_iterations(self, log2min: float, scale: float) -> int:
        """Iterations for full precision at the working scale."""
        prec = float(self.params.n / 2) / float(scale)
        start = 1.0 - 2.0 ** -abs(log2min)
        iters = 1
        while start >= prec:
            start *= start
            iters += 1
        return max(iters, 3)

    def goldschmidt_division(self, ct: Ciphertext, iterations: int | None = None,
                             log2min: float = 0.0) -> Ciphertext:
        """1/x for x ∈ (0, 2); |error| ≤ (1−x)^{2^{iterations+1}}."""
        ev = self.ev
        if iterations is None:
            iterations = self.estimate_iterations(log2min, float(ct.scale))
        a = ev.sub(ev.neg(ct), -2.0)   # 2 − x
        b = ev.sub(ev.neg(ct), -1.0)   # 1 − x
        for _ in range(iterations - 1):
            b = self._maybe_bootstrap(b, 1)
            a = self._maybe_bootstrap(a, 2)
            b = ev.rescale(ev.mul_relin(b, b))
            b = self._maybe_bootstrap(b, 1)
            tmp = ev.rescale(ev.mul_relin(*_align(a, b)))
            # bring a to tmp's scale (one level) before folding it in
            if Fraction(a.scale) != Fraction(tmp.scale):
                a = ev.set_scale(a.at_level(min(a.level, tmp.level + 1)), tmp.scale)
            a = ev.add(*_align(a, tmp))
        return a

    # -- interval normalization (ia.cr/2022/280 alg. 2, modified) ---------------

    def interval_normalization(self, ct: Ciphertext, log2max: float):
        """(norm, fac): norm = ct·fac ∈ [-1, 1] for ct ∈ [-2^log2max,
        2^log2max]; fac → 1/x for |x| > 1 and → 1 for |x| ≤ 1."""
        ev = self.ev
        norm = ct
        fac = None
        L = 2.45   # compression factor (experimental, ref :318)
        n = math.ceil(log2max / math.log2(L))
        for i in range(n):
            norm = self._maybe_bootstrap(norm, 4)
            if fac is not None:
                fac = self._maybe_bootstrap(fac, 1)
            c = 2.0 / math.sqrt(27.0 * L ** (2 * (n - 1 - i)))
            # z = 1 − (c·y)², depth 2
            z = ev.rescale(ev.mul_const(norm, c))
            z = ev.rescale(ev.mul_relin(z, z))
            z = ev.add(ev.neg(z), 1.0)
            z = self._maybe_bootstrap(z, 1)
            fac = z if fac is None else ev.rescale(ev.mul_relin(*_align(fac, z)))
            norm = ev.rescale(ev.mul_relin(*_align(norm, z)))
        return norm, fac

    # -- domain-specific inverses -----------------------------------------------

    def evaluate_positive_domain(self, ct: Ciphertext, log2min: float,
                                 log2max: float) -> Ciphertext:
        """1/x for x ∈ [2^{log2min}, 2^{log2max}]."""
        return self._evaluate(ct, log2min, log2max, fulldomain=False)

    def evaluate_negative_domain(self, ct: Ciphertext, log2min: float,
                                 log2max: float) -> Ciphertext:
        """1/x for x ∈ [-2^{log2max}, -2^{log2min}]."""
        ev = self.ev
        return ev.neg(self.evaluate_positive_domain(ev.neg(ct), log2min, log2max))

    def evaluate_full_domain(self, ct: Ciphertext, log2min: float, log2max: float,
                             sign_polys: list[Polynomial] | None = None) -> Ciphertext:
        """1/x for x ∈ [-2^{log2max}, -2^{log2min}] ∪ [2^{log2min}, 2^{log2max}]."""
        polys = sign_polys or self.sign_polys
        if polys is None:
            raise ValueError("full-domain inverse needs minimax sign polys")
        return self._evaluate(ct, log2min, log2max, fulldomain=True, sign_polys=polys)

    def _evaluate(self, ct: Ciphertext, log2min: float, log2max: float,
                  fulldomain: bool = False,
                  sign_polys: list[Polynomial] | None = None) -> Ciphertext:
        """ref evaluateNew:285."""
        ev = self.ev
        norm_fac = None
        if log2max > 0:
            cinv, norm_fac = self.interval_normalization(ct, log2max)
        else:
            cinv = ct

        sign = None
        if fulldomain:
            sign = self.minimax.evaluate(cinv, sign_polys)
            # |c·x| = sign(c·x)·(c·x)
            cinv = self._maybe_bootstrap(cinv, 1)
            cinv = ev.rescale(ev.mul_relin(*_align(cinv, sign)))

        iters = self.estimate_iterations(log2min, float(cinv.scale))
        cinv = self.goldschmidt_division(cinv, iters)

        if fulldomain:
            cinv = self._maybe_bootstrap(cinv, 1)
            cinv = ev.rescale(ev.mul_relin(*_align(cinv, sign)))

        if norm_fac is not None:
            cinv = self._maybe_bootstrap(cinv, 1)
            cinv = ev.rescale(ev.mul_relin(*_align(cinv, norm_fac)))
        return cinv
