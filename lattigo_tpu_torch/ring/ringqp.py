"""Product ring R_Q × R_P used by key material and key switching.

Counterpart of :mod:`lattigo_tpu.ring.ringqp`: a QP polynomial is a pair of
residue tensors (one per chain). ``p`` is ``None`` when the parameter set
has no auxiliary P basis.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lattigo_tpu_torch.ring import sampling


@dataclass
class QPPoly:
    """q: int64[..., lq+1, N], p: int64[..., LP, N] or None."""

    q: torch.Tensor
    p: torch.Tensor | None = None


class RingQP:
    """Paired ops over (ring_q, ring_p). ``level_q`` selects the Q-chain
    prefix; the P chain is always used in full."""

    def __init__(self, ring_q, ring_p=None):
        self.ring_q = ring_q
        self.ring_p = ring_p

    def _map(self, fq, fp, *polys: QPPoly) -> QPPoly:
        q = fq(*[x.q for x in polys])
        p = None
        if self.ring_p is not None and polys[0].p is not None:
            p = fp(*[x.p for x in polys])
        return QPPoly(q, p)

    def add(self, a: QPPoly, b: QPPoly, level_q: int | None = None) -> QPPoly:
        return self._map(lambda x, y: self.ring_q.add(x, y, level_q),
                         lambda x, y: self.ring_p.add(x, y), a, b)

    def sub(self, a: QPPoly, b: QPPoly, level_q: int | None = None) -> QPPoly:
        return self._map(lambda x, y: self.ring_q.sub(x, y, level_q),
                         lambda x, y: self.ring_p.sub(x, y), a, b)

    def mform(self, a: QPPoly, level_q: int | None = None) -> QPPoly:
        return self._map(lambda x: self.ring_q.mform(x, level_q),
                         lambda x: self.ring_p.mform(x), a)

    def mul_mont(self, a: QPPoly, b: QPPoly, level_q: int | None = None) -> QPPoly:
        return self._map(lambda x, y: self.ring_q.mul_mont(x, y, level_q),
                         lambda x, y: self.ring_p.mul_mont(x, y), a, b)

    def ntt(self, a: QPPoly, level_q: int | None = None, lazy: bool = False) -> QPPoly:
        return self._map(lambda x: self.ring_q.ntt(x, level_q, lazy=lazy),
                         lambda x: self.ring_p.ntt(x, lazy=lazy), a)

    def intt(self, a: QPPoly, level_q: int | None = None, lazy: bool = False) -> QPPoly:
        return self._map(lambda x: self.ring_q.intt(x, level_q, lazy=lazy),
                         lambda x: self.ring_p.intt(x, lazy=lazy), a)

    def uniform(self, gen: torch.Generator, level_q: int | None = None,
                batch: tuple[int, ...] = ()) -> QPPoly:
        q = sampling.uniform(gen, self.ring_q, level_q, batch)
        if self.ring_p is None:
            return QPPoly(q)
        return QPPoly(q, sampling.uniform(gen, self.ring_p, None, batch))

    def lift_signed(self, x, level_q: int | None = None) -> QPPoly:
        """Lift ONE signed int64[..., N] vector into both chains."""
        p = None
        if self.ring_p is not None:
            p = sampling.lift_signed(self.ring_p, x)
        return QPPoly(sampling.lift_signed(self.ring_q, x, level_q), p)

    def sample_signed(self, gen: torch.Generator, dist,
                      level_q: int | None = None,
                      batch: tuple[int, ...] = ()) -> QPPoly:
        """Sample a small signed poly once and lift it to QP."""
        return self.lift_signed(
            sampling.signed(gen, self.ring_q.n, dist, batch), level_q)

    def at_level(self, a: QPPoly, level_q: int) -> QPPoly:
        return QPPoly(a.q[..., : level_q + 1, :], a.p)


def stack(polys: list[QPPoly], dim: int = 0) -> QPPoly:
    """Stack QP polys along a new axis (e.g. gadget digits)."""
    q = torch.stack([x.q for x in polys], dim=dim)
    p = None
    if polys[0].p is not None:
        p = torch.stack([x.p for x in polys], dim=dim)
    return QPPoly(q, p)
