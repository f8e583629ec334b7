"""Ciphertext / Plaintext containers.

Counterpart of :mod:`lattigo_tpu.rlwe.elements`: a ciphertext is ONE
tensor ``int64[..., degree+1, level+1, N]``; degree and level are carried
by the shape, leading axes batch, and the metadata (domain flags, scale)
sits beside it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch


@dataclass
class Plaintext:
    """Degree-0 element: value int64[..., level+1, N]."""

    value: torch.Tensor
    is_ntt: bool = True
    is_montgomery: bool = False
    scale: Any = 1.0

    @property
    def level(self) -> int:
        return self.value.shape[-2] - 1

    @property
    def n(self) -> int:
        return self.value.shape[-1]

    def replace(self, **kw) -> "Plaintext":
        return dataclasses.replace(self, **kw)


@dataclass
class Ciphertext:
    """Degree-d element: value int64[..., d+1, level+1, N];
    ``value[..., i, :, :]`` is the coefficient of s^i in μ = Σ_i ct[i]·s^i."""

    value: torch.Tensor
    is_ntt: bool = True
    is_montgomery: bool = False
    scale: Any = 1.0

    @property
    def degree(self) -> int:
        return self.value.shape[-3] - 1

    @property
    def level(self) -> int:
        return self.value.shape[-2] - 1

    @property
    def n(self) -> int:
        return self.value.shape[-1]

    def replace(self, **kw) -> "Ciphertext":
        return dataclasses.replace(self, **kw)

    def at_level(self, level: int) -> "Ciphertext":
        return self.replace(value=self.value[..., : level + 1, :])


def ciphertext_from_polys(polys: list[torch.Tensor], **meta) -> Ciphertext:
    return Ciphertext(value=torch.stack(polys, dim=-3), **meta)
