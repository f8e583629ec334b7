"""RLWE parameter sets.

Counterpart of :mod:`lattigo_tpu.rlwe.params`: a :class:`Parameters`
object owns the Q/P modulus chains, the :class:`~lattigo_tpu_torch.ring.Ring`
objects (tables on ``device``), the noise distributions and the
key-switching machinery. The moduli are drawn exactly as the JAX package
draws them, so the same literal gives the same chains.
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass

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

    def to_json(self) -> str:
        """Every field (a scheme's own ones too) as JSON, each distribution
        as {"type": class name, **fields}: the JAX package's text."""
        d = asdict(self)
        d["xe"] = {"type": type(self.xe).__name__, **getattr(self.xe, "__dict__", {})}
        d["xs"] = {"type": type(self.xs).__name__, **getattr(self.xs, "__dict__", {})}
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "ParametersLiteral":
        """Inverse of :meth:`to_json`, as an instance of ``cls``: a BGV or
        CKKS literal reads its own fields back (``t``,
        ``log_default_scale``)."""
        d = json.loads(s)
        dists = {"DiscreteGaussian": DiscreteGaussian, "Ternary": Ternary,
                 "Uniform": Uniform}
        for k in ("xe", "xs"):
            spec = dict(d[k])
            d[k] = dists[spec.pop("type")](**spec)
        for k in ("q", "p", "log_q", "log_p"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        return cls(**d)


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

    @property
    def max_level_p(self) -> int:
        """|P| − 1: −1 for a parameter set with no P basis."""
        return len(self.p_moduli) - 1

    def q_big_int(self, level: int | None = None) -> int:
        return self.ring_q.modulus_at_level(
            self.max_level if level is None else level)

    def p_big_int(self) -> int:
        r = 1
        for p in self.p_moduli:
            r *= p
        return r

    def log_q_big(self, level: int | None = None) -> int:
        """Bit length of Q at ``level``."""
        return self.q_big_int(level).bit_length()

    # -- noise ---------------------------------------------------------------

    def noise_fresh_sk(self) -> float:
        """σ of fresh secret-key encryption noise."""
        return getattr(self.xe, "sigma", 3.2)

    def noise_fresh_pk(self) -> float:
        """σ of fresh public-key encryption noise: σ·sqrt(h + 2), h the
        secret's expected Hamming weight."""
        sigma = getattr(self.xe, "sigma", 3.2)
        if isinstance(self.xs, Ternary):
            h = (self.xs.hamming_weight if self.xs.hamming_weight
                 else int(self.n * (1 - self.xs.p)))
        else:
            h = self.n
        return sigma * math.sqrt(h + 2.0)

    # -- Galois elements -----------------------------------------------------

    @property
    def galois_gen(self) -> int:
        """Generator of the rotation subgroup: 5."""
        return 5

    def galois_element(self, k: int) -> int:
        """Galois element of a cyclic column rotation by k."""
        return pow(self.galois_gen, k, self.nth_root)

    def galois_element_inverse(self, gal_el: int) -> int:
        return pow(gal_el, -1, self.nth_root)

    @property
    def galois_element_order_two(self) -> int:
        """The row-swap / conjugation element NthRoot − 1."""
        return self.nth_root - 1

    def __repr__(self) -> str:
        return (f"Parameters(logN={self.log_n}, "
                f"logQ={[q.bit_length() for q in self.q_moduli]}, "
                f"logP={[p.bit_length() for p in self.p_moduli]}, "
                f"device={self.device})")

    def __eq__(self, other) -> bool:
        """Equal degree, chains and ring type (on any device)."""
        return (isinstance(other, Parameters)
                and self.n == other.n
                and self.q_moduli == other.q_moduli
                and self.p_moduli == other.p_moduli
                and self.ring_type == other.ring_type)

    def __hash__(self) -> int:
        return hash((self.n, tuple(self.q_moduli), tuple(self.p_moduli),
                     self.ring_type))
