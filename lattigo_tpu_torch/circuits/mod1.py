"""Homomorphic x mod 1 (EvalMod) — the heart of CKKS bootstrapping.

Counterpart of :mod:`lattigo_tpu.circuits.mod1` (ref ``circuits/ckks/mod1``):
the same polynomial coefficients, scale targets and constants, value for
value, so the two packages give the same residues. Strategy (ref
mod1_parameters.go:17, mod1_evaluator.go:31):

    y ∈ [−K, K], |y mod 1| ≤ 2^{−log_message_ratio}
    1. map to the polynomial's Chebyshev variable (one constant mul)
    2. c = P(v) ≈ cos(2π(y − 1/4)/2^r)   (scaled by (2π)^{-1/2^r})
    3. r × double angle: c ← 2c² − s²  → c = cos(2π(y − 1/4)) = sin(2πy)
    4. out = c/(2π) ≈ y mod 1   (+ optional arcsine correction polynomial)

Three approximation types (ref mod1_parameters.go:23-26 Type):

* ``COS_DISCRETE`` — Han–Ki interpolation (ia.cr/2019/688) with nodes only
  near the integers; lowest degree for large K. Its Chebyshev variable is
  u = y/K ∈ [−1, 1] (the re-expansion happens inside
  :mod:`lattigo_tpu_torch.utils.cosine`), so every homomorphic power-basis value
  is bounded by ~1; coefficients are carried as exact Fractions from the
  256-bit generator into the constant encoder.
* ``COS_CONTINUOUS`` — full-interval Chebyshev of the same cosine.
* ``SIN_CONTINUOUS`` — full-interval Chebyshev of sin(2πx)/2π, no double
  angle.

Without the arcsine correction, the 1/(2π) factor is embedded into the
polynomial coefficients via the double-angle-compatible scaling (ref
mod1_evaluator.go:61): with s_0 = (2π)^{-1/2^r}, c_0 = s_0·cos(θ/2^r) and
the modified recurrence c ← 2c² − s_i², s_i ← s_i², the invariant
c_i = s_i·cos(θ/2^{r-i}) holds and the final iterate equals sin(2πy)/(2π)
at no extra depth.

With the arcsine correction (``arcsine_degree > 0``, the low-message-ratio
recipe of the ratio-2² published sets), the cosine polynomial is kept
UNSCALED (s_0 = 1, ref mod1_parameters.go:157 ``sqrt2pi = 1.0`` when
Mod1InvDegree > 0): the double-angle output is u = sin(2πy) at full unit
dynamic range, and the final stage evaluates the odd monomial series
asin(u)/(2π) = u/(2π)·(1 + u²/6 + 3u⁴/40 + …) whose coefficients are all
≤ 1/(2π) (ref mod1_parameters.go:139-148). Evaluating the series on
sin(2πy)/(2π) instead (coefficients growing like (2π)^{d−1}, an earlier
revision) amplifies the power-basis quantisation error by the leading
coefficient — 2^11 at degree 7 — and makes the correction WORSE than no
correction.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction

import numpy as np

from lattigo_tpu_torch.circuits import polynomial as poly_mod
from lattigo_tpu_torch.circuits.polynomial import (
    Polynomial, PolynomialEvaluator, chebyshev_approximate, CHEBYSHEV,
)
from lattigo_tpu_torch.rlwe.elements import Ciphertext

COS_DISCRETE = "cos_discrete"
SIN_CONTINUOUS = "sin_continuous"
COS_CONTINUOUS = "cos_continuous"


def _sqrt_fraction(f: Fraction) -> Fraction:
    """√f as a Fraction with ~60 fractional bits (big-float sqrt analog)."""
    n = (f.numerator << 120) // f.denominator
    return Fraction(math.isqrt(n), 1 << 60)


def _mpf_to_fraction(x) -> Fraction:
    """Exact conversion mpmath.mpf → Fraction (binary float = dyadic)."""
    sign, man, exp, _ = x._mpf_
    if man == 0:
        return Fraction(0)
    v = Fraction(-man if sign else man)
    return v * Fraction(2) ** exp


@dataclass(frozen=True)
class Mod1Parameters:
    """ref mod1_parameters.go:32 Mod1ParametersLiteral."""

    k: int = 16                  # interval half-width (#(q-multiples) covered)
    degree: int = 30             # polynomial degree of the approximation
    double_angle: int = 3        # r (ignored for SIN_CONTINUOUS)
    log_message_ratio: int = 8   # log2(q/|m|) bound
    arcsine_degree: int = 0      # optional arcsine correction
    mod1_type: str = COS_CONTINUOUS
    # Working scale of the evaluation (ref mod1_parameters.go LogScale /
    # the EvalModLogScale design): when set, the bootstrap relabels the
    # C2S output to 2^log_scale so the Chebyshev power basis stays pinned
    # to the (≈ 2^log_scale) chain primes — without it the basis scale
    # drifts by (Δ_in/q_em) per doubling and the shrinking scales turn
    # RLWE noise into message-level error. None keeps the input scale.
    log_scale: int | None = None
    # Hamming weight of the secret live during ModUp (the ephemeral
    # weight under sparse-secret encapsulation). When set, the evaluator
    # subtracts the approximation's EXPECTED value over the lift-integer
    # distribution I ~ round(Σ_h U(−½,½)): the Chebyshev/Han–Ki error
    # f(y) has E[f(I)] ≠ 0, and that DC bias — harmless per slot — lands
    # almost entirely on the slots whose embedding root ζ^{5^j} is
    # closest to 1 after SlotsToCoeffs (gain ≈ 1.27·n at slot 0),
    # producing a worst-slot error many bits above the mean (measured
    # with the JAX package on a TPU: 7.4 worst vs 14.8 mean bits at
    # N15QP768). No reference analog — the reference reports only
    # mean/L2 precision and carries the same tail silently.
    debias_weight: int | None = None

    @property
    def sc_fac(self) -> int:
        return 1 << (0 if self.mod1_type == SIN_CONTINUOUS
                     else self.double_angle)


class Mod1Evaluator:
    """ref mod1_evaluator.go:31."""

    def __init__(self, ckks_eval, mod1_params: Mod1Parameters):
        self.ev = ckks_eval
        self.p1 = mod1_params
        self.poly_eval = PolynomialEvaluator(ckks_eval)
        self._poly = self._gen_poly()
        self._dc_bias = (self._expected_bias()
                         if mod1_params.debias_weight else 0.0)

    def _model_out(self, y) -> float:
        """Exact (mpmath) value of the full composite — Chebyshev ladder,
        double-angle, optional arcsine — at the point y; ≈ y mod 1."""
        from mpmath import mp, mpf
        with mp.workprec(160):
            u = mpf(y) / self.p1.k
            cs = [_mpf_to_fraction(c) if hasattr(c, "_mpf_") else Fraction(c)
                  for c in self._poly.coeffs]
            cs = [mpf(c.numerator) / c.denominator for c in cs]
            bk1 = bk2 = mpf(0)
            for c in cs[:0:-1]:
                bk1, bk2 = c + 2 * u * bk1 - bk2, bk1
            c0 = cs[0] + u * bk1 - bk2
            si = mpf(self._sqrt2pi)
            for _ in range(self._r):
                c0 = 2 * c0 * c0 - si * si
                si = si * si
            if self.p1.arcsine_degree > 0:
                a = 1 / (2 * mp.pi)
                out = a * c0
                pw = c0
                for d in range(3, self.p1.arcsine_degree + 1, 2):
                    a = a * (d * d - 4 * d + 4) / (d * d - d)
                    pw = pw * c0 * c0
                    out += a * pw
                c0 = out
            return float(c0)

    def _i_weights(self) -> dict[int, float]:
        """P(I = i) for the lift integer I ≈ round(Σ_h U(−½,½)) — exact
        Irwin–Hall CDF differences for small h, Gaussian beyond."""
        import math as _m
        h = self.p1.debias_weight
        k = self.p1.k
        if h <= 64:
            fact = _m.factorial(h)

            def cdf(x: Fraction) -> Fraction:   # X = Σ_h U(0,1) ≤ x
                if x <= 0:
                    return Fraction(0)
                if x >= h:
                    return Fraction(1)
                s = Fraction(0)
                for j in range(int(x) + 1):
                    s += (-1) ** j * _m.comb(h, j) * (x - j) ** h
                return s / fact

            w = {}
            for i in range(-k + 1, k):
                lo = Fraction(2 * i - 1, 2) + Fraction(h, 2)
                hi = Fraction(2 * i + 1, 2) + Fraction(h, 2)
                p = cdf(hi) - cdf(lo)
                if p > 0:
                    w[i] = float(p)
            return w
        sig = _m.sqrt(h / 12.0)
        w = {i: _m.exp(-0.5 * (i / sig) ** 2) for i in range(-k + 1, k)}
        tot = sum(w.values())
        return {i: v / tot for i, v in w.items()}

    def _expected_bias(self) -> float:
        """E[f(I)] — the approximation error's DC component (see
        Mod1Parameters.debias_weight)."""
        return sum(p * self._model_out(i)
                   for i, p in self._i_weights().items())

    @property
    def _r(self) -> int:
        return 0 if self.p1.mod1_type == SIN_CONTINUOUS else self.p1.double_angle

    @property
    def _sqrt2pi(self) -> float:
        """Scale factor folded into the cosine polynomial & double-angle
        constants. 1.0 with the arcsine correction (the 1/(2π) then lives
        in the asin series, ref mod1_parameters.go:136-158)."""
        if self.p1.arcsine_degree > 0:
            return 1.0
        return (2 * math.pi) ** (-1.0 / self.p1.sc_fac)

    def _gen_poly(self) -> Polynomial:
        p1 = self.p1
        k, scfac = p1.k, p1.sc_fac
        s = self._sqrt2pi
        if p1.arcsine_degree > 0 and p1.mod1_type == SIN_CONTINUOUS:
            raise ValueError("arcsine correction requires a cosine mod1 type")

        if p1.mod1_type == COS_DISCRETE:
            from mpmath import mp, mpf, pi as mp_pi
            from lattigo_tpu_torch.utils.cosine import approximate_cos
            with mp.workprec(256):
                c = approximate_cos(k, p1.degree,
                                    float(1 << p1.log_message_ratio),
                                    p1.double_angle)
                s_mp = (mpf(1) if p1.arcsine_degree > 0
                        else (1 / (2 * mp_pi)) ** (mpf(1) / scfac))
                coeffs = [_mpf_to_fraction(ci * s_mp) for ci in c]
            return Polynomial(coeffs, basis=CHEBYSHEV)

        if p1.mod1_type == SIN_CONTINUOUS:
            def f(t):
                return math.sin(2 * math.pi * k * t) / (2 * math.pi)
        else:  # COS_CONTINUOUS
            def f(t):
                return s * math.cos(2 * math.pi * (k * t - 0.25) / scfac)
        return chebyshev_approximate(f, p1.degree, interval=(-1.0, 1.0))

    def evaluate(self, ct: Ciphertext, pre_mapped: bool = False) -> Ciphertext:
        """ct slots hold y ∈ [−K, K]; returns slots ≈ (y mod 1) centered.
        With ``pre_mapped`` the interval map y → y/K was already applied by
        the caller (folded into the C2S matrices in the bootstrap) and no
        level is spent on it.

        Scale choreography (ref mod1_evaluator.go:52-58): each double-angle
        squaring maps scale σ → σ²/q, so the polynomial is evaluated at the
        target ∏√q staging scale that makes the r squarings land exactly on
        the working scale. The landing primes are predicted with the
        metadata-only :class:`~lattigo_tpu_torch.circuits.polynomial.SimEvaluator`
        (the reference's polynomial_evaluator_sim.go analog). For this to be
        numerically stable the chain primes spanning the mod-1 levels must
        be ≈ the working scale (the reference's EvalModLogScale design).
        """
        ev = self.ev
        p = ev.params
        p1 = self.p1
        k, r = p1.k, self._r
        s = self._sqrt2pi

        # map y to the polynomial variable u = y/K (all types; see
        # _gen_poly — the CosDiscrete re-expansion happens at generation).
        # In the bootstrap the caller folds this constant into the C2S
        # matrices (pre_mapped=True, free — ref
        # bootstrapping/evaluator.go:190 C2SScaling); standalone callers
        # pay one constant mul, exactly like the reference's own mod1 test
        # (mod1_evaluator_test.go:151 Mul(1/(K·QDiff))+Rescale).
        # A scale-metadata relabel would also be exact but drifts the
        # working scale off the chain primes; the drift compounds through
        # the Chebyshev squaring chain (×2 → ×2^16 at T_16) and destroys
        # the coefficient quantisation headroom CosDiscrete needs.
        if not pre_mapped:
            t = ev.rescale(ev.mul_const(ct, Fraction(1, k)))
        else:
            t = ct

        # The scale the double-angle chain lands on: the PINNED working
        # scale when set (ref mod1_evaluator.go:46 res.Scale =
        # ScalingFactor(); the caller relabels afterwards), else the
        # default scale. Pinning matters: the squaring chain maps scale
        # σ → σ²/q, whose fixed point is q — a target at the ≈ q chain
        # primes keeps every Chebyshev power AND double-angle iterate at
        # ≈ q, so RLWE noise stays at 2^-log_scale relative. A target
        # below the chain primes makes the BASIS scales collapse
        # geometrically toward zero going up the squaring ladder
        # (σ, σ²/q, σ⁴/q³, …) until ciphertext noise IS the message —
        # measured 14+ bits of bootstrap precision loss at Δ=2^45 under
        # 2^60 EvalMod primes.
        base = (Fraction(2) ** p1.log_scale if p1.log_scale is not None
                else Fraction(p.default_scale_fraction))
        # plan: poly output level with a throwaway target, then stage the
        # real target backward through the r double-angle rescales
        lc = poly_mod.simulate(p, t.level, Fraction(t.scale), self._poly,
                               base).level
        target = base
        for i in range(r):
            target = _sqrt_fraction(
                target * Fraction(p.q_moduli[lc - r + 1 + i]))

        c = self.poly_eval.evaluate(t, self._poly, target)
        # double angle with embedded scale: c_i = s_i·cos(θ/2^{r-i}) with
        # s_{i+1} = s_i² satisfies c_{i+1} = 2c_i² − s_i²; s_r = 1/(2π).
        si = s
        for _ in range(r):
            sq = ev.mul_relin(c, c)
            sq = ev.add(sq, sq)
            sq = ev.rescale(sq)
            c = ev.sub(sq, si * si)
            si = si * si
        if p1.arcsine_degree > 0:
            # Arcsine correction on u = sin(2πy) (s_0 was 1, so the
            # double-angle output has unit dynamic range): evaluate
            # asin(u)/(2π) = Σ a_d u^d with a_1 = 1/(2π) and
            # a_d = a_{d−2}·(d²−4d+4)/(d²−d) for odd d — every coefficient
            # ≤ 1/(2π), so power-basis quantisation error is never
            # amplified (ref mod1_parameters.go:139-148 Mod1InvPoly).
            coeffs = [0.0] * (p1.arcsine_degree + 1)
            a = 1.0 / (2.0 * math.pi)
            coeffs[1] = a
            for d in range(3, p1.arcsine_degree + 1, 2):
                a = a * (d * d - 4 * d + 4) / (d * d - d)
                coeffs[d] = a
            # evaluated at the working scale, like the reference's
            # Evaluate(res, mod1InvPoly, res.Scale) — mod1_evaluator.go:140
            c = self.poly_eval.evaluate(
                c, Polynomial(coeffs, basis="monomial"), base)
        if self._dc_bias:
            # remove the approximation's expected value over the lift
            # integers (free: one exact constant add) — the DC of the
            # per-slot error otherwise concentrates on the near-1-root
            # slots after S2C, dominating worst-slot precision (see
            # Mod1Parameters.debias_weight)
            c = ev.sub(c, self._dc_bias)
        return c
