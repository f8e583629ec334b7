"""Polynomial samplers: uniform, ternary, discrete Gaussian.

Counterpart of :mod:`lattigo_tpu.ring.sampling`, drawing from an explicit
``torch.Generator`` where the JAX package takes a ``jax.random`` key. The
draws happen on the generator's device and land on the ring's device.
The two packages give different numbers from the same seed; the
distributions are the same:

* ``Uniform``: uniform in [0, q_i) per limb, from 126 random bits reduced
  mod q_i (statistical distance < 2^-96 from uniform);
* ``Ternary(p)``: coefficients in {-1, 0, 1}, Pr[0] = p, Pr[±1] = (1-p)/2;
* ``Ternary(hamming_weight=h)``: exactly h nonzero ±1 coefficients;
* ``DiscreteGaussian(sigma, bound)``: rounded Gaussian clamped to |x| ≤ bound.

Small signed samples are drawn once per coefficient and lifted into every
RNS limb.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lattigo_tpu_torch.ring import modops


@dataclass(frozen=True)
class Uniform:
    pass


@dataclass(frozen=True)
class Ternary:
    p: float | None = None          # probability of 0
    hamming_weight: int | None = None

    def __post_init__(self):
        if (self.p is None) == (self.hamming_weight is None):
            raise ValueError("Ternary takes exactly one of p / hamming_weight")


@dataclass(frozen=True)
class DiscreteGaussian:
    sigma: float = 3.2
    bound: float = 19.2


DEFAULT_XE = DiscreteGaussian(3.2, 19.2)
DEFAULT_XS = Ternary(p=1.0 / 3.0)


def lift_signed(ring, x, level: int | None = None):
    """Lift small signed ints x (int64[..., N]) to residues int64[..., L, N]."""
    l = ring.max_level if level is None else level
    return torch.remainder(x.to(ring.device)[..., None, :], ring.q[: l + 1])


def ternary_signed(gen: torch.Generator, n: int, dist: Ternary = DEFAULT_XS,
                   batch: tuple[int, ...] = ()):
    """Signed ternary sample int64[batch..., N] on the generator's device."""
    shape = batch + (n,)
    dev = gen.device
    if dist.p is not None:
        u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)
        sign = torch.randint(0, 2, shape, generator=gen, device=dev) * 2 - 1
        return torch.where(u < dist.p, torch.zeros_like(sign), sign)
    h = dist.hamming_weight
    sign = torch.randint(0, 2, batch + (h,), generator=gen, device=dev) * 2 - 1
    base = torch.cat([sign, sign.new_zeros(batch + (n - h,))], dim=-1)
    perm = torch.rand(shape, generator=gen, device=dev).argsort(dim=-1)
    return base.gather(-1, perm)


def gaussian_signed(gen: torch.Generator, n: int,
                    dist: DiscreteGaussian = DEFAULT_XE,
                    batch: tuple[int, ...] = ()):
    """Signed rounded-Gaussian sample int64[batch..., N]."""
    g = torch.randn(batch + (n,), generator=gen, device=gen.device,
                    dtype=torch.float64) * dist.sigma
    return torch.round(g.clamp(-dist.bound, dist.bound)).to(torch.int64)


def signed(gen: torch.Generator, n: int, dist, batch: tuple[int, ...] = ()):
    if isinstance(dist, Ternary):
        return ternary_signed(gen, n, dist, batch)
    if isinstance(dist, DiscreteGaussian):
        return gaussian_signed(gen, n, dist, batch)
    raise TypeError(f"distribution {dist!r} has no small-signed form")


def uniform(gen: torch.Generator, ring, level: int | None = None,
            batch: tuple[int, ...] = ()):
    """Uniform poly in [0, q_i) per limb: int64[batch..., L, N]."""
    l = (ring.max_level if level is None else level) + 1
    shape = batch + (l, ring.n)
    hi, lo = (torch.randint(0, (1 << 63) - 1, shape, generator=gen,
                            device=gen.device).to(ring.device)
              for _ in range(2))
    q, _, bhi, blo = ring.tables(level)
    # (hi·2^64 + lo) mod q  =  MForm(hi mod q) + (lo mod q)
    return modops.add_mod(
        modops.mform(modops.bred_add(hi, q, bhi), q, bhi, blo),
        modops.bred_add(lo, q, bhi), q)

