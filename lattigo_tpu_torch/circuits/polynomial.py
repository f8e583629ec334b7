"""Depth-optimal polynomial evaluation (Paterson–Stockmeyer).

Counterpart of :mod:`lattigo_tpu.circuits.polynomial` (ref
``circuits/common/polynomial`` + the CKKS binding). The reference
pre-plans every rescaling with a big-float SimEvaluator
(``polynomial_evaluator_sim.go``); here scales are exact Fractions, so the
plan IS the evaluation: constants are encoded at exactly the scale that
makes every branch land on its target (ref UpdateLevelAndScaleGiantStep),
and branch scales match by construction. Every scale, level and constant
is the JAX package's, value for value, so the two give the same residues.

Supports monomial and Chebyshev bases; Chebyshev factorization follows
T_{n+j} division: q_j = 2·c_{n+j}, r_{n-j} −= c_{n+j}
(ref utils/bignum/polynomial.go:258 Factorize).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from fractions import Fraction

import numpy as np

from lattigo_tpu_torch.rlwe.elements import Ciphertext

MONOMIAL = "monomial"
CHEBYSHEV = "chebyshev"


@dataclass
class Polynomial:
    """Polynomial in monomial or Chebyshev basis (ref bignum/polynomial.go)."""

    coeffs: list[complex]
    basis: str = MONOMIAL
    interval: tuple[float, float] = (-1.0, 1.0)

    @property
    def degree(self) -> int:
        return len(self.coeffs) - 1

    def factorize(self, n: int):
        """p = q·B_n + r with B the basis element (ref Factorize:258)."""
        c = list(self.coeffs)
        r = c[:n] + [0] * max(0, n - len(c))
        q = [0] * (self.degree - n + 1)
        if self.degree >= n:
            q[0] = c[n]
        if self.basis == MONOMIAL:
            for i in range(n + 1, self.degree + 1):
                q[i - n] = c[i]
        else:  # Chebyshev: T_a·T_n = (T_{a+n} + T_{|a-n|})/2
            for i, j in zip(range(n + 1, self.degree + 1), range(1, 10**9)):
                q[i - n] = 2 * c[i]
                r[n - j] = r[n - j] - c[i]
        return (Polynomial(q, self.basis, self.interval),
                Polynomial(r, self.basis, self.interval))


@dataclass
class PolynomialVector:
    """Different polynomials applied to different slots (ref
    circuits/common/polynomial/polynomial.go:64 PolynomialVector).

    ``mapping[k]`` lists the slot indices that evaluate ``polys[k]``;
    unmapped slots evaluate to 0. All polynomials must share basis and
    interval (the power basis is common to every slot); evaluation costs
    the same as a single polynomial of the maximum degree, with scalar
    coefficient multiplies replaced by plaintext-vector multiplies.
    """

    polys: list[Polynomial]
    mapping: dict[int, list[int]]

    def __post_init__(self):
        if len({p.basis for p in self.polys}) != 1:
            raise ValueError("mixed bases")
        if len({p.interval for p in self.polys}) != 1:
            raise ValueError("mixed intervals")
        if not all(0 <= k < len(self.polys) for k in self.mapping):
            raise ValueError("mapping names a polynomial that does not exist")

    @property
    def basis(self) -> str:
        return self.polys[0].basis

    @property
    def interval(self) -> tuple[float, float]:
        return self.polys[0].interval

    @property
    def degree(self) -> int:
        return max(p.degree for p in self.polys)

    def factorize(self, n: int):
        qs, rs = zip(*(p.factorize(n) for p in self.polys))
        return (PolynomialVector(list(qs), self.mapping),
                PolynomialVector(list(rs), self.mapping))

    def nonzero_degrees(self) -> list[int]:
        return sorted({i for p in self.polys
                       for i, c in enumerate(p.coeffs) if i > 0 and c != 0})

    def coeff_slots(self, i: int, slots: int) -> np.ndarray:
        """Slot vector of the i-th coefficient of each slot's polynomial."""
        out = np.zeros(slots, dtype=np.complex128)
        for k, sl in self.mapping.items():
            p = self.polys[k]
            if i <= p.degree and p.coeffs[i] != 0:
                out[np.asarray(sl, dtype=np.int64)] = complex(p.coeffs[i])
        return out

    def evaluate_plain(self, x: np.ndarray) -> np.ndarray:
        """Plaintext recomputation oracle over slot values x."""
        out = np.zeros(len(x), dtype=np.complex128)
        for k, sl in self.mapping.items():
            p = self.polys[k]
            idx = np.asarray(sl, dtype=np.int64)
            if p.basis == MONOMIAL:
                acc = np.zeros(len(idx), dtype=np.complex128)
                for c in reversed(p.coeffs):
                    acc = acc * x[idx] + c
            else:
                a, b = p.interval
                u = (2 * x[idx] - (a + b)) / (b - a)
                t0, t1 = np.ones_like(u), u
                acc = p.coeffs[0] * t0
                if p.degree >= 1:
                    acc = acc + p.coeffs[1] * t1
                for i in range(2, p.degree + 1):
                    t0, t1 = t1, 2 * u * t1 - t0
                    acc = acc + p.coeffs[i] * t1
            out[idx] = acc
        return out


def chebyshev_approximate(fn, degree: int, interval=(-1.0, 1.0)) -> Polynomial:
    """Chebyshev interpolation at Chebyshev nodes (ref bignum/chebyshev_approximation.go)."""
    a, b = interval
    n = degree + 1
    nodes = np.cos(np.pi * (np.arange(n) + 0.5) / n)
    x = 0.5 * (b - a) * nodes + 0.5 * (b + a)
    y = np.array([fn(v) for v in x], dtype=np.complex128)
    coeffs = []
    for k in range(n):
        ck = (2.0 / n) * np.sum(y * np.cos(np.pi * k * (np.arange(n) + 0.5) / n))
        coeffs.append(ck)
    coeffs[0] = coeffs[0] / 2
    return Polynomial(coeffs, basis=CHEBYSHEV, interval=interval)


def optimal_split(log_degree: int) -> int:
    """ref bignum.OptimalSplit: logSplit = logDegree>>1 (+1 heuristic)."""
    log_split = log_degree >> 1
    if log_degree - log_split > log_split:
        log_split += 1
    return max(1, log_split)


class PowerBasis:
    """X^n (or T_n) ladder with relinearized, rescaled squaring chains
    (ref circuits/common/polynomial/power_basis.go:17)."""

    def __init__(self, ct: Ciphertext, basis: str = MONOMIAL):
        self.basis = basis
        self.powers: dict[int, Ciphertext] = {1: ct}

    def gen_power(self, n: int, ev) -> Ciphertext:
        if n in self.powers:
            return self.powers[n]
        if self.basis == MONOMIAL:
            a = 1 << (n.bit_length() - 1)
            if a == n:
                a = b = n // 2
            else:
                b = n - a
            xa, xb = self.gen_power(a, ev), self.gen_power(b, ev)
            out = ev.rescale(ev.mul_relin(xa, xb.at_level(min(xa.level, xb.level))))
        else:
            a, b = (n + 1) // 2, n // 2
            xa, xb = self.gen_power(a, ev), self.gen_power(b, ev)
            prod = ev.mul_relin(xa, xb.at_level(min(xa.level, xb.level)))
            prod = ev.add(prod, prod)             # 2·T_a·T_b
            c = abs(a - b)
            if c == 0:
                out = ev.sub(ev.rescale(prod), 1.0)   # T_0 = 1 (const: exact)
            else:
                # T_c's label (2^50-pinned at T_1, drifting by chain-prime
                # deviations deeper) differs from prod's by ~2^-33 at
                # 50-bit primes (q = 2^50 ± 2^17): letting sub's
                # _match_scales RELABEL would fold that ratio into the
                # VALUES as a multiplicative error which the next squaring
                # RECTIFIES into a DC bias — the bias then concentrates on
                # the near-1-root slots after S2C with gain ~1.27n and
                # dominates worst-slot precision (measured: T_3 carried
                # δ=−2^-34.3, T_6=2T_3²−1 a DC of 2δ, worst slot 7.4 bits
                # vs 14.8 mean at N15QP768). Instead, land T_c EXACTLY on
                # prod's scale with a ~2^50-quantised constant one (rel.
                # error 2^-50, at the f64 floor) before the shared rescale.
                tc = self.gen_power(c, ev)
                tc = tc.at_level(min(tc.level, prod.level))
                tcs = ev.mul_const(
                    tc, 1.0,
                    const_scale=Fraction(prod.scale) / Fraction(tc.scale))
                out = ev.rescale(ev.sub(prod, tcs))
        self.powers[n] = out
        return out


class SimCiphertext:
    """Metadata-only ciphertext: (level, scale) for evaluation planning.

    The reference pre-plans every rescaling with a big-float SimEvaluator
    (ref polynomial_evaluator_sim.go:7); this is its analog — running the
    *same* evaluation code against metadata-only objects to learn output
    levels/scales without touching device data.
    """

    __slots__ = ("level", "scale", "value")

    def __init__(self, level: int, scale):
        self.level = level
        self.scale = Fraction(scale)
        self.value = np.zeros(0, dtype=np.int64)  # placates zero-ct paths

    def at_level(self, level: int) -> "SimCiphertext":
        return SimCiphertext(min(self.level, level), self.scale)

    def replace(self, value=None, scale=None) -> "SimCiphertext":
        return SimCiphertext(self.level,
                             self.scale if scale is None else scale)


class SimEvaluator:
    """Level/scale shadow of the CKKS evaluator (ref polynomial_evaluator_sim.go)."""

    def __init__(self, params):
        self.params = params

    def add(self, ct, op):
        if isinstance(op, SimCiphertext):
            return SimCiphertext(min(ct.level, op.level),
                                 max(ct.scale, op.scale))
        return ct

    sub = add

    def mul_relin(self, ct0, ct1):
        return SimCiphertext(min(ct0.level, ct1.level), ct0.scale * ct1.scale)

    def mul_const(self, ct, c, const_scale=None):
        cs = (Fraction(self.params.q_moduli[ct.level])
              if const_scale is None else Fraction(const_scale))
        return SimCiphertext(ct.level, ct.scale * cs)

    def rescale(self, ct):
        return SimCiphertext(ct.level - 1,
                             ct.scale / Fraction(self.params.q_moduli[ct.level]))


def simulate(params, level: int, scale, poly: "Polynomial",
             target_scale=None) -> SimCiphertext:
    """Dry-run a P-S evaluation: returns the output (level, scale)."""
    sim = PolynomialEvaluator.__new__(PolynomialEvaluator)
    sim.ev = SimEvaluator(params)
    sim.params = params
    sim.encoder = None
    return sim.evaluate(SimCiphertext(level, scale), poly, target_scale)


class PolynomialEvaluator:
    """P-S evaluation on CKKS ciphertexts (ref polynomial_evaluator.go:23).

    ``encoder`` is only needed for :class:`PolynomialVector` inputs (slot
    coefficient vectors are encoded as plaintexts).
    """

    def __init__(self, ckks_eval, encoder=None):
        self.ev = ckks_eval
        self.params = ckks_eval.params
        self.encoder = encoder

    def evaluate(self, ct: Ciphertext, poly: Polynomial | PolynomialVector,
                 target_scale: Fraction | None = None) -> Ciphertext:
        """Depth-exact P-S evaluation: consumes exactly bit_length(degree)
        levels (ref Evaluate docstring "ceil(log2(deg+1)) levels").

        The level choreography mirrors the reference's recursePS planning
        (ref polynomial.go:109, polynomial_evaluator_sim.go): baby-step
        inner products are left with a PENDING rescale (scale ≈ target·q)
        that the following giant-step multiplication consumes
        (ref EvaluateMonomial: Rescale → Mul → Add), and ONE final rescale
        lands the output on target_scale.
        """
        p = self.params
        target_scale = (p.default_scale_fraction if target_scale is None
                        else Fraction(target_scale))
        d = poly.degree
        if d < 0:
            raise ValueError("empty polynomial")
        if d == 0:
            return self._eval_baby_at(None, poly, ct, ct.level, target_scale)

        log_degree = max(1, d.bit_length())
        log_split = optimal_split(log_degree)

        pb = PowerBasis(ct, poly.basis)
        for k in range(log_split, log_degree):          # giants (2^k ≤ 2^{logD-1})
            pb.gen_power(1 << k, self.ev)
        for i in range(3, min(1 << log_split, d + 1)):  # babies
            pb.gen_power(i, self.ev)

        # output level BEFORE the final rescale (ref PolynomialDepth)
        target_level = ct.level - (log_degree - 1)
        if target_level < 1:
            raise ValueError(f"not enough levels: need {log_degree} below {ct.level}")
        out = self._recurse_ps(pb, poly, d, True, log_split,
                               target_level, target_scale)
        out = self.ev.rescale(out)
        return out

    # -- recursion ------------------------------------------------------------

    def _recurse_ps(self, pb: PowerBasis, poly, max_deg: int, lead: bool,
                    log_split: int, target_level: int,
                    target_scale: Fraction) -> Ciphertext:
        """Returns poly(ct) at `target_level` with a pending scale:
        target_scale·q[target_level] when `lead`, else exactly target_scale
        (the caller's pending factor is already inside target_scale) —
        ref recursePS + UpdateLevelAndScaleBabyStep/GiantStep.
        """
        d = poly.degree
        q_mod = self.params.q_moduli
        if d < (1 << log_split):
            # Lead babies whose planned level would exceed their powers'
            # levels are re-split with a smaller base so the plan stays
            # consistent (ref recursePS:118 — THE condition that makes the
            # depth bound exact; without it the deep baby powers drag the
            # chain one level down).
            if (lead and log_split > 1 and d > 0
                    and max_deg > (1 << max_deg.bit_length()) - (1 << (log_split - 1))):
                return self._recurse_ps(
                    pb, poly, max_deg, lead,
                    optimal_split(max(1, d.bit_length())),
                    target_level, target_scale)
            scale = target_scale * (Fraction(q_mod[target_level]) if lead
                                    else Fraction(1))
            return self._eval_baby_at(pb, poly, pb.powers[1],
                                      target_level, scale)

        m = 1 << log_split
        while m < (d >> 1) + 1:
            m <<= 1
        pb.gen_power(m, self.ev)
        xm = pb.powers[m]
        qi = Fraction(q_mod[target_level if lead else target_level + 1])
        ts_new = target_scale * qi / Fraction(xm.scale)

        q_poly, r_poly = poly.factorize(m)
        mdq = max_deg
        mdr = m - 1 if max_deg == d else max_deg - (d - m + 1)

        q_ct = self._recurse_ps(pb, q_poly, mdq, lead, log_split,
                                target_level + 1, ts_new)
        q_ct = self.ev.rescale(q_ct)
        lvl = min(q_ct.level, xm.level)
        prod = self.ev.mul_relin(q_ct.at_level(lvl), xm.at_level(lvl))
        r_ct = self._recurse_ps(pb, r_poly, mdr, False, log_split,
                                target_level, Fraction(prod.scale))
        lvl2 = min(prod.level, r_ct.level)
        return self.ev.add(prod.at_level(lvl2), r_ct.at_level(lvl2))

    def _eval_baby_at(self, pb, poly, base, level: int,
                      scale: Fraction) -> Ciphertext:
        """Σ_i c_i·B_i + c_0 evaluated AT (level, scale), no rescale —
        the pending rescale is the caller's (ref
        EvaluatePolynomialVectorFromPowerBasis)."""
        if isinstance(poly, PolynomialVector):
            return self._eval_baby_vector_at(pb, poly, base, level, scale)
        ev = self.ev
        nz = [i for i, c in enumerate(poly.coeffs) if i > 0 and c != 0]
        if not nz:
            zero = base.replace(value=base.value * 0,
                                scale=scale).at_level(level)
            return ev.add(zero, complex(poly.coeffs[0])) if poly.coeffs[0] else zero
        acc = None
        for i in nz:
            xi = pb.powers[i]
            assert xi.level >= level, (
                f"baby power T_{i} at level {xi.level} below plan {level}")
            xi = xi.at_level(level)
            cs = scale / Fraction(xi.scale)
            # pass coefficients through unconverted: Fraction coeffs
            # (CosDiscrete) quantise exactly inside mul_const
            term = ev.mul_const(xi, poly.coeffs[i], const_scale=cs)
            acc = term if acc is None else ev.add(acc, term)
        if poly.coeffs[0]:
            acc = ev.add(acc, poly.coeffs[0])
        return acc

    def _eval_baby_vector_at(self, pb, poly: PolynomialVector, base,
                             level: int, scale: Fraction) -> Ciphertext:
        """Vector variant: scalar coefficient multiplies become plaintext
        slot-vector multiplies (ref circuits/ckks/polynomial vector
        CoefficientGetter path)."""
        ev = self.ev
        if self.encoder is None:
            raise ValueError(
                "PolynomialVector evaluation needs PolynomialEvaluator(ev, encoder)")
        slots = self.params.max_slots
        nz = poly.nonzero_degrees()
        c0 = poly.coeff_slots(0, slots)
        if not nz:
            zero = base.replace(value=base.value * 0,
                                scale=scale).at_level(level)
            if np.any(c0):
                pt = self.encoder.encode(c0, level=level, scale=scale)
                return ev.add(zero, pt)
            return zero
        acc = None
        for i in nz:
            xi = pb.powers[i]
            assert xi.level >= level, (
                f"baby power T_{i} at level {xi.level} below plan {level}")
            xi = xi.at_level(level)
            cs = scale / Fraction(xi.scale)
            pt = self.encoder.encode(poly.coeff_slots(i, slots),
                                     level=level, scale=cs)
            term = ev.mul(xi, pt)
            acc = term if acc is None else ev.add(acc, term)
        if np.any(c0):
            pt = self.encoder.encode(c0, level=acc.level,
                                     scale=Fraction(acc.scale))
            acc = ev.add(acc, pt)
        return acc
