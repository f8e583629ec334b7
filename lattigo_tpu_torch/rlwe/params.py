"""RLWE parameter sets.

Counterpart of :mod:`lattigo_tpu.rlwe.params`: a :class:`Parameters`
object owns the Q/P modulus chains, the :class:`~lattigo_tpu_torch.ring.Ring`
objects (tables on ``device``), the noise distributions and the
key-switching machinery. The moduli are drawn exactly as the JAX package
draws them, so the same literal gives the same chains.
"""

from __future__ import annotations

from dataclasses import dataclass

from lattigo_tpu_torch.device import resolve_device
from lattigo_tpu_torch.ring.basis_extension import BasisExtender, Decomposer
from lattigo_tpu_torch.ring.ring import Ring, STANDARD
from lattigo_tpu_torch.ring.ringqp import RingQP
from lattigo_tpu_torch.ring.sampling import (
    DEFAULT_XE, DEFAULT_XS, DiscreteGaussian, Ternary, Uniform,
)
from lattigo_tpu_torch.utils.primes import NTTFriendlyPrimesGenerator

__all__ = [
    "ParametersLiteral", "Parameters", "gen_moduli",
    "DiscreteGaussian", "Ternary", "Uniform", "DEFAULT_XE", "DEFAULT_XS",
]


@dataclass(frozen=True)
class ParametersLiteral:
    """User-facing parameter literal: exactly one of ``q`` / ``log_q``;
    ``p`` / ``log_p`` optional (no key-switching basis when absent)."""

    log_n: int
    q: tuple[int, ...] | None = None
    p: tuple[int, ...] | None = None
    log_q: tuple[int, ...] | None = None
    log_p: tuple[int, ...] | None = None
    xe: object = DEFAULT_XE
    xs: object = DEFAULT_XS
    ring_type: str = STANDARD
    ntt_flag: bool = True
    default_scale: float = 1.0


def gen_moduli(log_n: int, nth_root: int, log_q: tuple[int, ...],
               log_p: tuple[int, ...]) -> tuple[list[int], list[int]]:
    """NTT-friendly primes per requested bit size: one generator per
    distinct size, sizes assigned in order (Q first, then P)."""
    gens: dict[int, NTTFriendlyPrimesGenerator] = {}

    def draw(b: int) -> int:
        if b not in gens:
            gens[b] = NTTFriendlyPrimesGenerator(b, nth_root)
        return gens[b].next_alternating_prime()

    q = [draw(b) for b in log_q]
    p = [draw(b) for b in log_p]
    return q, p


class Parameters:
    """Resolved parameter set with every table on ``device`` (CUDA unless
    the caller names another device)."""

    def __init__(self, literal: ParametersLiteral, device=None):
        lit = literal
        if (lit.q is None) == (lit.log_q is None):
            raise ValueError("exactly one of q / log_q must be set")
        if lit.p is not None and lit.log_p is not None:
            raise ValueError("at most one of p / log_p may be set")
        self.device = resolve_device(device)
        self.literal = lit
        self.log_n = lit.log_n
        self.n = 1 << lit.log_n
        self.ring_type = lit.ring_type
        self.nth_root = (2 if lit.ring_type == STANDARD else 4) * self.n
        if lit.q is not None:
            q = list(lit.q)
            p = list(lit.p) if lit.p is not None else []
        else:
            q, p = gen_moduli(lit.log_n, self.nth_root, tuple(lit.log_q),
                              tuple(lit.log_p or ()))
        self.q_moduli = q
        self.p_moduli = p
        self.ring_q = Ring(self.n, q, lit.ring_type, self.device)
        self.ring_p = Ring(self.n, p, lit.ring_type, self.device) if p else None
        self.ring_qp = RingQP(self.ring_q, self.ring_p)
        self.xe = lit.xe
        self.xs = lit.xs
        self.ntt_flag = lit.ntt_flag
        self.default_scale = lit.default_scale
        self.basis_extender = (BasisExtender(self.ring_q, self.ring_p)
                               if self.ring_p is not None else None)
        self.decomposer = (Decomposer(self.ring_q, self.ring_p)
                           if self.ring_p is not None else None)

    @property
    def max_level(self) -> int:
        return len(self.q_moduli) - 1

    def q_big_int(self, level: int | None = None) -> int:
        return self.ring_q.modulus_at_level(
            self.max_level if level is None else level)

    def p_big_int(self) -> int:
        r = 1
        for p in self.p_moduli:
            r *= p
        return r

    def __repr__(self) -> str:
        return (f"Parameters(logN={self.log_n}, "
                f"logQ={[q.bit_length() for q in self.q_moduli]}, "
                f"logP={[p.bit_length() for p in self.p_moduli]}, "
                f"device={self.device})")
