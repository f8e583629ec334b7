"""BGV/BFV parameters: RLWE parameters + plaintext modulus T.

Counterpart of :mod:`lattigo_tpu.schemes.bgv.params`: adds the plaintext
ring R_T (a :class:`Ring` over the single modulus T, for slot packing) and
the T-scaling constants of the unified BGV/BFV evaluator (plaintexts are
stored MSB-encoded as m·T^{-1} mod Q; tensoring pre-multiplies by T) and
the BFV double basis ``ring_qmul``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.ring.ring import Ring, u64_tensor
from lattigo_tpu_torch.utils.primes import NTTFriendlyPrimesGenerator


@dataclass(frozen=True)
class ParametersLiteral(rlwe.ParametersLiteral):
    """RLWE literal + plaintext modulus T."""

    t: int = 65537


class Parameters(rlwe.Parameters):
    """Resolved BGV/BFV parameters on ``device``."""

    def __init__(self, literal: ParametersLiteral, device=None):
        super().__init__(replace(literal, ntt_flag=True), device)
        t = literal.t
        if t in self.q_moduli:
            raise ValueError("T must be coprime to Q")
        self.t = t
        # full batching needs T ≡ 1 mod 2N
        self.max_slots = self.n if (t - 1) % (2 * self.n) == 0 else 0
        self.ring_t = Ring(self.n, [t], device=self.device) if self.max_slots else None
        lq = len(self.q_moduli)
        # T·2^128 mod q_i: one mred(x, ·) gives the M-form of T·x
        self.t_mont2 = u64_tensor([(t << 128) % q for q in self.q_moduli],
                                  self.device, (lq, 1))
        # MForm(T^{-1} mod q_i): encoding to the MSB form m·T^{-1}
        self.tinv_mont = u64_tensor(
            [(pow(t, -1, q) << 64) % q for q in self.q_moduli], self.device, (lq, 1))
        # q_l^{-1} mod T for scale tracking across rescaling
        self.qinv_mod_t = [pow(q % t, -1, t) for q in self.q_moduli]

    @property
    def plaintext_modulus(self) -> int:
        return self.t

    @functools.cached_property
    def ring_qmul(self) -> Ring:
        """The BFV auxiliary basis QMul, |QMul| ≥ |Q|·N·T, for exact
        scale-invariant tensoring: as many 61-bit primes as Q has, drawn
        by ``next_alternating_prime`` and skipping Q's primes and T (the
        JAX package's primes). Built on first use, on the parameters'
        device. Its primes are ≥ 2^30, so its NTT is the plain radix-2
        engine (``radix2-plain``) at every N. Half of them lie just above
        2^61 (by < 2^23): the int64 values stay below 2^63 there (the
        forward NTT's lazy values below 3.5q) except the inverse NTT's sum
        x0 + x1 when both lie within 2^25 of 2q, a chance below 2^-70 a
        butterfly."""
        gen = NTTFriendlyPrimesGenerator(61, self.nth_root)
        primes = []
        while len(primes) < len(self.q_moduli):
            c = gen.next_alternating_prime()
            if c not in self.q_moduli and c != self.t:
                primes.append(c)
        return Ring(self.n, primes, device=self.device)

    def scale_mul(self, s1: int, s2: int) -> int:
        return s1 * s2 % self.t

    def scale_div_q(self, s: int, level: int) -> int:
        """Scale update after dropping q_level."""
        return s * self.qinv_mod_t[level] % self.t
