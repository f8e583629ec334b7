"""t-out-of-N thresholdization of secret keys (Shamir sharing over R_QP).

Counterpart of :mod:`lattigo_tpu.multiparty.threshold`: each party
Shamir-shares its additive secret-key share; any t active parties turn
their Shamir shares into additive shares of the whole key with Lagrange
coefficients at the public Shamir points.

Shamir points are small public nonzero integers; scalar arithmetic is per
RNS modulus, and polynomials stay in the NTT + Montgomery key domain, so
the recombined shares plug into every protocol.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lattigo_tpu_torch.ring import modops
from lattigo_tpu_torch.ring.ring import u64_tensor
from lattigo_tpu_torch.ring.ringqp import QPPoly
from lattigo_tpu_torch.rlwe.keys import SecretKey
from lattigo_tpu_torch.rlwe.params import Parameters


@dataclass
class ShamirPolynomial:
    """coeffs[0] = the secret, coeffs[1..t-1] uniform in R_QP (M-form)."""

    coeffs: list[QPPoly]


class Thresholdizer:
    def __init__(self, params: Parameters):
        self.params = params

    def gen_shamir_polynomial(self, gen: torch.Generator, threshold: int,
                              sk_share: SecretKey) -> ShamirPolynomial:
        rqp = self.params.ring_qp
        coeffs = [sk_share.value]
        for _ in range(threshold - 1):
            coeffs.append(rqp.mform(rqp.uniform(gen)))
        return ShamirPolynomial(coeffs)

    def gen_shamir_secret_share(self, point: int,
                                poly: ShamirPolynomial) -> QPPoly:
        """The polynomial at the public point, by Horner's rule."""
        rqp = self.params.ring_qp
        acc = poly.coeffs[-1]
        for c in reversed(poly.coeffs[:-1]):
            acc = rqp.add(rqp.mul_scalar(acc, point), c)
        return acc

    @staticmethod
    def aggregate_shares(params: Parameters, s1: QPPoly, s2: QPPoly) -> QPPoly:
        return params.ring_qp.add(s1, s2)


class Combiner:
    """Lagrange recombination at 0 over the active points."""

    def __init__(self, params: Parameters, threshold: int):
        self.params = params
        self.threshold = threshold

    def gen_additive_share(self, active_points: list[int], own_point: int,
                           own_share: QPPoly) -> SecretKey:
        """share_j · λ_j with λ_j = Π_{i≠j} x_i/(x_i − x_j), per modulus."""
        p = self.params
        if len(active_points) < self.threshold:
            raise ValueError(f"{len(active_points)} active points, threshold "
                             f"{self.threshold}")

        def lagrange(m: int) -> int:
            lam = 1
            for x in active_points:
                if x != own_point:
                    lam = lam * x % m
                    lam = lam * pow((x - own_point) % m, -1, m) % m
            return lam

        def apply(part, ring):
            lam = u64_tensor([(lagrange(m) << 64) % m for m in ring.moduli],
                             ring.device, (len(ring.moduli), 1))
            return modops.mred(part, lam, ring.q, ring.qinv, ring.small)

        out_p = None if own_share.p is None else apply(own_share.p, p.ring_p)
        return SecretKey(QPPoly(apply(own_share.q, p.ring_q), out_p))
