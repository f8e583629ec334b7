"""Exact polynomial evaluation on BGV/BFV ciphertexts (Paterson–Stockmeyer).

Counterpart of :mod:`lattigo_tpu.circuits.bgv_polynomial` (ref
``circuits/bgv/polynomial`` and ``ring/interpolation.go``): Lagrange
interpolation over Z_T on the host, and a monomial-basis P-S evaluator
with exact Z_T coefficients. No scale planning is needed: BGV scales live
in Z_T and additions re-align them exactly by a scalar multiplication, so
the recursion is plain integer arithmetic; only levels are aligned.
"""

from __future__ import annotations

import torch

from lattigo_tpu_torch.rlwe.elements import Ciphertext


def interpolate_mod_t(xs: list[int], ys: list[int], t: int) -> list[int]:
    """Coefficients (little-endian) of the unique polynomial of degree
    < len(xs) through (x_i, y_i) mod t; t prime, the x_i distinct mod t."""
    n = len(xs)
    if len(ys) != n:
        raise ValueError("xs and ys differ in length")
    coeffs = [0] * n
    for i in range(n):
        # Lagrange basis l_i(x) = Π_{j≠i} (x − x_j)/(x_i − x_j)
        num = [1]
        denom = 1
        for j in range(n):
            if j == i:
                continue
            new = [0] * (len(num) + 1)
            for k, c in enumerate(num):
                new[k] = (new[k] - xs[j] * c) % t
                new[k + 1] = (new[k + 1] + c) % t
            num = new
            denom = denom * (xs[i] - xs[j]) % t
        s = ys[i] * pow(denom, -1, t) % t
        for k, c in enumerate(num):
            coeffs[k] = (coeffs[k] + s * c) % t
    return coeffs


def function_mod_t(fn, t: int) -> list[int]:
    """Interpolate an arbitrary function Z_t → Z_t (degree t−1; t prime)."""
    xs = list(range(t))
    return interpolate_mod_t(xs, [fn(x) % t for x in xs], t)


class BGVPolynomialEvaluator:
    """Monomial-basis P-S evaluation with exact Z_T coefficients."""

    def __init__(self, bgv_eval):
        self.ev = bgv_eval
        self.params = bgv_eval.params

    def _zero(self, ct: Ciphertext) -> Ciphertext:
        return ct.replace(value=torch.zeros_like(ct.value))

    def evaluate(self, ct: Ciphertext, coeffs: list[int]) -> Ciphertext:
        """p(ct) for p = Σ coeffs[i]·x^i over Z_T."""
        t = self.params.t
        coeffs = [int(c) % t for c in coeffs]
        d = len(coeffs) - 1
        while d > 0 and coeffs[d] == 0:
            d -= 1
        if d == 0:
            zero = self._zero(ct)
            return self.ev.add(zero, coeffs[0]) if coeffs[0] else zero

        log_degree = max(1, d.bit_length())
        log_split = max(1, log_degree >> 1)
        if log_degree - log_split > log_split:
            log_split += 1
        n1 = 1 << log_split

        powers: dict[int, Ciphertext] = {1: ct}

        def gen_power(n: int) -> Ciphertext:
            if n in powers:
                return powers[n]
            a = 1 << (n.bit_length() - 1)
            if a == n:
                a = b = n // 2
            else:
                b = n - a
            xa, xb = gen_power(a), gen_power(b)
            out = self.ev.rescale(self.ev.mul_relin(
                xa, xb.at_level(min(xa.level, xb.level))))
            powers[n] = out
            return out

        m = n1
        while m <= d:
            gen_power(m)
            m <<= 1
        for i in range(2, min(n1, d + 1)):
            gen_power(i)

        def recurse(cs: list[int]) -> Ciphertext | None:
            """Σ cs[i]·x^i; None for the zero polynomial."""
            dd = len(cs) - 1
            while dd > 0 and cs[dd] == 0:
                dd -= 1
            cs = cs[: dd + 1]
            if dd < n1:
                acc = None
                for i in range(1, dd + 1):
                    if cs[i] == 0:
                        continue
                    term = self.ev.mul_scalar(powers[i], cs[i])
                    acc = term if acc is None else self.ev.add(acc, term)
                if cs[0]:
                    acc = self.ev.add(acc if acc is not None else self._zero(ct),
                                      cs[0])
                return acc
            mm = n1
            while mm < (dd >> 1) + 1:
                mm <<= 1
            q_ct = recurse(cs[mm:])
            r_ct = recurse(cs[:mm])
            xm = powers[mm]
            if q_ct is None:
                return r_ct
            lvl = min(q_ct.level, xm.level)
            prod = self.ev.rescale(self.ev.mul_relin(q_ct.at_level(lvl),
                                                     xm.at_level(lvl)))
            if r_ct is None:
                return prod
            return self.ev.add(prod, r_ct.at_level(min(prod.level, r_ct.level)))

        out = recurse(coeffs)
        if out is None:
            raise ValueError("the polynomial evaluated to nothing")
        return out
