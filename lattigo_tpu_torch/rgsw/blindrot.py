"""LMKCDEY blind rotation: programmable bootstrapping / LUT evaluation.

Counterpart of :mod:`lattigo_tpu.rgsw.blindrot` (ia.cr/2022/198,
Algorithms 3 and 7). An LWE sample (b, a) ∈ Z_{2N}^{n+1} is extracted from
a coefficient-domain RLWE ciphertext over the small "LWE" ring; the
accumulator in the large "BR" ring starts at (f(X^{-g})·X^{-g·b}, 0) and is
multiplied by RGSW(X^{s_j}) for every LWE secret coefficient, grouped by
the discrete log of a_j = ±g^k mod 2N so that one automorphism by g^v
serves a whole group (window w). The result encrypts f(X)·X^{b+⟨a,s⟩}: f
evaluated at the phase.

Device/host split: the grouping depends on the data (the mod-switched
``a`` vector), so the schedule is made on the host from the n_lwe values
of ``a``, pulled to the host once per blind rotation, and drives a host
loop of device steps (external products and automorphisms). The ±0
buckets follow the JAX package (the −0 bucket before the line-12 σ_{−g},
the +0 bucket last), not the reference's folding of −0 into +0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lattigo_tpu_torch.ring import automorphism as auto_mod
from lattigo_tpu_torch.rgsw import rgsw as rgsw_mod
from lattigo_tpu_torch.rlwe.elements import Ciphertext
from lattigo_tpu_torch.rlwe.evaluator import Evaluator as RlweEvaluator
from lattigo_tpu_torch.rlwe.keys import EvaluationKeySet, KeyGenerator, SecretKey
from lattigo_tpu_torch.rlwe.params import Parameters

WINDOW_SIZE = 10  # parameter w of Algorithm 3


def init_test_polynomial(g, scale: float, params_br: Parameters,
                         a: float, b: float, level: int | None = None):
    """NTT-domain test polynomial F with F[X^{-phase}]·X^{phase} = g(phase).

    Negacyclic layout: coefficients i ∈ [0, N/2] hold g on [-1, 0], the top
    half holds −g on ]0, 1[ (the monomial sign wrap). Inputs are assumed
    normalised by (2x − a − b)/(b − a).
    """
    p = params_br
    level = p.max_level if level is None else level
    n = p.n
    interval = 2.0 / n
    coeffs = [0] * n
    for i in range(n // 2 + 1):
        x = (-interval * i * (b - a) + b + a) / 2.0
        coeffs[i] = int(round(g(x) * scale))
    for i in range(n // 2 + 1, n):
        x = (interval * (n - i) * (b - a) + b + a) / 2.0
        coeffs[i] = -int(round(g(x) * scale))
    return p.ring_q.ntt(p.ring_q.from_int_coeffs(coeffs, level), level)


@dataclass
class BlindRotationKeySet:
    """RGSW(X^{s_i}) per LWE secret coefficient, and the Galois keys."""

    brk: list            # list[rgsw_mod.Ciphertext], one per LWE sk coefficient
    evk: EvaluationKeySet  # Galois keys for g^v (v = 1..w) and 2N − g


def lwe_secret_ints(params_lwe: Parameters, sk_lwe: SecretKey) -> list[int]:
    """The centered integer coefficients of an LWE secret key."""
    rq = params_lwe.ring_q
    s = rq.imform(rq.intt(sk_lwe.value.q[..., :1, :], 0), 0)
    return rq.to_int_coeffs(s, 0, centered=True)


def galois_elements(params_br: Parameters, window: int = WINDOW_SIZE) -> list[int]:
    """The Galois elements the blind rotation uses: g^v mod 2N for
    v = 1..window, and 2N − g."""
    g, two_n = params_br.galois_gen, 2 * params_br.n
    return sorted({pow(g, v, two_n) for v in range(1, window + 1)}
                  | {two_n - g})


def gen_evaluation_keys(gen: torch.Generator, params_br: Parameters,
                        sk_br: SecretKey, params_lwe: Parameters,
                        sk_lwe: SecretKey,
                        window: int = WINDOW_SIZE) -> BlindRotationKeySet:
    """RGSW(X^{s_i}) for the n_lwe secret coefficients, drawn in one batch,
    and the Galois keys of :func:`galois_elements`."""
    s_int = lwe_secret_ints(params_lwe, sk_lwe)
    brk = rgsw_mod.Encryptor(params_br, sk_br).encrypt_monomials(gen, s_int)
    gks = KeyGenerator(params_br).gen_galois_keys(
        gen, galois_elements(params_br, window), sk_br)
    return BlindRotationKeySet(brk=brk, evk=EvaluationKeySet(galois_keys=gks))


class BlindRotationEvaluator:
    """LWE extraction + LMKCDEY blind rotation."""

    def __init__(self, params_br: Parameters, params_lwe: Parameters):
        self.p_br = params_br
        self.p_lwe = params_lwe
        # ±g^k mod 2N → ±k
        two_n = 2 * params_br.n
        self.dlog = {}
        pow_g = 1
        for i in range(params_br.n // 2):
            self.dlog[pow_g] = i
            self.dlog[two_n - pow_g] = -i
            pow_g = pow_g * params_br.galois_gen % two_n

    def _mod_switch_to_2n(self, poly, level: int, make_odd: bool) -> np.ndarray:
        """round(x·2N/Q) mod 2N per coefficient (on the host); with
        ``make_odd``, even nonzero results move to the odd neighbour."""
        p = self.p_lwe
        two_n = 2 * self.p_br.n
        ints = p.ring_q.to_int_coeffs(poly, level, centered=False)
        q_big = p.q_big_int(level)
        out = np.empty(p.n, dtype=np.int64)
        for i, x in enumerate(ints):
            v = ((x * two_n + q_big // 2) // q_big) % two_n
            if make_odd and v & 1 == 0 and v != 0:
                v ^= 1
            out[i] = v
        return out

    def _core(self, a_2n: np.ndarray, acc: Ciphertext, ev: RlweEvaluator,
              brk: BlindRotationKeySet, window: int) -> Ciphertext:
        p = self.p_br
        two_n = 2 * p.n
        g = p.galois_gen

        # ±k → [j...] with a_j = ±g^k
        sets: dict[int, list[int]] = {}
        for j, aj in enumerate(a_2n.tolist()):
            if aj == 0:
                continue  # a zero coefficient contributes X^0
            if aj & 1 != 1:
                raise ValueError("a[j] not odd: not in Z_2N^*")
            sets.setdefault(self.dlog[aj], []).append(j)

        def gal(v: int) -> int:
            return pow(g, v, two_n)

        def step(k: int, v: int, acc: Ciphertext) -> tuple[int, Ciphertext]:
            """One iteration of lines 3-9 / 13-19 of Algorithm 3."""
            if k in sets:
                if v != 0:
                    acc = ev.automorphism(acc, gal(v))
                    v = 0
                for j in sets[k]:
                    acc = rgsw_mod.external_product(ev, acc, brk.brk[j])
            v += 1
            if v == window or k == 1:
                acc = ev.automorphism(acc, gal(v))
                v = 0
            return v, acc

        n_half = p.n // 2
        v = 0
        for i in range(n_half - 1, 0, -1):       # negative set: a_j = −g^i
            v, acc = step(-i, v, acc)
        # ±0 buckets: dlog cannot tell +g^0 (a_j = 1) from −g^0 (a_j = 2N−1),
        # so they are rebuilt by value. The −0 bucket goes before the line-12
        # σ_{−g} (after flushing pending rotations) so its factors pick up
        # exactly −g^{N/2} = −1; the +0 bucket goes last with no rotation.
        a_list = a_2n.tolist()
        neg_zero = [j for j, aj in enumerate(a_list) if aj == two_n - 1]
        pos_zero = [j for j, aj in enumerate(a_list) if aj == 1]
        if neg_zero:
            if v != 0:
                acc = ev.automorphism(acc, gal(v))
                v = 0
            for j in neg_zero:
                acc = rgsw_mod.external_product(ev, acc, brk.brk[j])
        if v != 0:
            acc = ev.automorphism(acc, gal(v))
            v = 0
        acc = ev.automorphism(acc, two_n - g)     # line 12: acc(X^{-g})
        for i in range(n_half - 1, 0, -1):       # positive set: a_j = g^i
            v, acc = step(i, v, acc)
        if pos_zero:
            if v != 0:
                acc = ev.automorphism(acc, gal(v))
                v = 0
            for j in pos_zero:
                acc = rgsw_mod.external_product(ev, acc, brk.brk[j])
        elif v != 0:
            acc = ev.automorphism(acc, gal(v))
        return acc

    def lwe_samples(self, ct: Ciphertext) -> tuple[np.ndarray, np.ndarray]:
        """(b, a) in Z_2N of the LWE samples the RLWE ciphertext holds:
        b[i] for slot i, a with the convolution turned into a dot product
        (a'_0 = a_0, a'_j = −a_{N−j}) for slot 0."""
        p_lwe = self.p_lwe
        mask = 2 * self.p_br.n - 1
        level = ct.level
        v = ct.value
        if ct.is_ntt:
            v = p_lwe.ring_q.intt(v, level)
        b_2n = self._mod_switch_to_2n(v[..., 0, :, :], level, make_odd=False)
        a_q = self._mod_switch_to_2n(v[..., 1, :, :], level, make_odd=True)
        a_2n = np.empty_like(a_q)
        a_2n[0] = a_q[0]
        a_2n[1:] = (-a_q[:0:-1]) & mask
        return b_2n, a_2n

    def evaluate(self, ct: Ciphertext, test_polys: dict,
                 brk: BlindRotationKeySet,
                 window: int = WINDOW_SIZE) -> dict[int, Ciphertext]:
        """Blind-rotate the LWE samples extracted at the given slot indices.

        ct: RLWE ciphertext over params_lwe. test_polys[i]: NTT-domain test
        polynomial (from :func:`init_test_polynomial`) for slot i. Returns
        {i: RLWE_br(f_i(X)·X^{phase_i})} with phase ≈ round(2N·m_i/q).
        """
        p_br = self.p_br
        two_n = 2 * p_br.n
        mask = two_n - 1
        ev = RlweEvaluator(p_br, brk.evk)
        b_2n, a_2n = self.lwe_samples(ct)
        out: dict[int, Ciphertext] = {}
        prev = 0
        for index in sorted(test_polys):
            # shift a by X^{index−prev} mod 2N
            shift = index - prev
            if shift:
                a_2n = np.roll(a_2n, shift)
                a_2n[:shift] = (-a_2n[:shift]) & mask
            prev = index
            b = int(b_2n[index])

            # acc = (f(X^{-g})·X^{-g·b}, 0)
            f = test_polys[index]
            lvl_br = f.shape[-2] - 1
            xb_m = rgsw_mod.monomials(p_br, [b], lvl_br)[0]
            c0 = p_br.ring_q.mul_mont(f, xb_m, lvl_br)
            c0 = auto_mod.automorphism_ntt(c0, p_br.n, two_n - p_br.galois_gen)
            acc = Ciphertext(value=torch.stack([c0, torch.zeros_like(c0)], dim=-3),
                             is_ntt=True)
            out[index] = self._core(a_2n, acc, ev, brk, window)
        return out
