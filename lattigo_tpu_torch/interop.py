"""Carry state between the JAX package and the port as numpy arrays.

The JAX package's objects hold ``uint64`` residues; the port holds the same
bit patterns as ``torch.int64``. These helpers take the numpy ``uint64``
arrays (the caller does the ``np.asarray`` on the JAX side) and build the
port's objects on a chosen device, and turn the port's objects back into
numpy ``uint64`` arrays. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from lattigo_tpu_torch.ring.ringqp import QPPoly
from lattigo_tpu_torch.rlwe.elements import Ciphertext, Plaintext
from lattigo_tpu_torch.rlwe.keys import (
    GadgetCiphertext, RelinearizationKey, SecretKey,
)


def to_torch(a, device) -> torch.Tensor:
    """numpy uint64 array -> int64 tensor with the same bits on ``device``."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def qp_from_numpy(q, p, device) -> QPPoly:
    return QPPoly(to_torch(q, device), None if p is None else to_torch(p, device))


def qp_to_numpy(x: QPPoly) -> tuple[np.ndarray, np.ndarray | None]:
    return to_numpy(x.q), None if x.p is None else to_numpy(x.p)


def secret_key_from_numpy(q, p, device) -> SecretKey:
    """Secret key from its QP parts (NTT + Montgomery form)."""
    return SecretKey(qp_from_numpy(q, p, device))


def relinearization_key_from_numpy(q, p, device) -> RelinearizationKey:
    """Relinearization key from its gadget rows: q [beta, 2, LQ, N],
    p [beta, 2, LP, N]."""
    return RelinearizationKey(GadgetCiphertext(qp_from_numpy(q, p, device)))


def ciphertext_from_numpy(value, device, is_ntt: bool = True,
                          scale=1) -> Ciphertext:
    return Ciphertext(value=to_torch(value, device), is_ntt=is_ntt, scale=scale)


def plaintext_from_numpy(value, device, is_ntt: bool = True,
                         scale=1) -> Plaintext:
    return Plaintext(value=to_torch(value, device), is_ntt=is_ntt, scale=scale)
