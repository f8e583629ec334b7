"""Carry state between the JAX package and the port as numpy arrays.

The JAX package's objects hold ``uint64`` residues; the port holds the same
bit patterns as ``torch.int64``. These helpers take the numpy ``uint64``
arrays (the caller does the ``np.asarray`` on the JAX side) and build the
port's objects on a chosen device, and turn the port's objects back into
numpy ``uint64`` arrays. Metadata travels as it is: a CKKS scale stays an
exact ``Fraction``; a parameter literal travels as its JSON
(:func:`parameters_literal_from_json`). Nothing here imports JAX.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from lattigo_tpu_torch.circuits.bootstrapping import BootstrappingKeys
from lattigo_tpu_torch.circuits.lintrans import LinearTransformation
from lattigo_tpu_torch.multiparty.threshold import ShamirPolynomial
from lattigo_tpu_torch.rgsw.blindrot import BlindRotationKeySet
from lattigo_tpu_torch.rgsw.rgsw import Ciphertext as RgswCiphertext
from lattigo_tpu_torch.ring.ringqp import QPPoly
from lattigo_tpu_torch.rlwe.elements import Ciphertext, Plaintext
from lattigo_tpu_torch.rlwe.ring_packing import RingSwitchingKeys
from lattigo_tpu_torch.rlwe.keys import (
    CompressedGadgetCiphertext, EvaluationKey, EvaluationKeySet,
    GadgetCiphertext, GaloisKey, PublicKey, RelinearizationKey, SecretKey,
)
from lattigo_tpu_torch.rlwe.params import ParametersLiteral
from lattigo_tpu_torch.schemes import bgv, ckks


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
    """Secret key from its QP parts (NTT + Montgomery form), on either ring
    type: a conjugate-invariant secret holds its N CI NTT values."""
    return SecretKey(qp_from_numpy(q, p, device))


def relinearization_key_from_numpy(q, p, device, base2: int = 0) -> RelinearizationKey:
    """Relinearization key from its gadget rows: q [beta, 2, LQ, N],
    p [beta, 2, LP, N] (``base2`` > 0: the power-of-two gadget's rows)."""
    return RelinearizationKey(gadget_from_numpy(q, p, device, base2))


def ciphertext_from_numpy(value, device, is_ntt: bool = True,
                          scale=1) -> Ciphertext:
    return Ciphertext(value=to_torch(value, device), is_ntt=is_ntt, scale=scale)


def plaintext_from_numpy(value, device, is_ntt: bool = True,
                         scale=1) -> Plaintext:
    return Plaintext(value=to_torch(value, device), is_ntt=is_ntt, scale=scale)


def gadget_from_numpy(q, p, device, base2: int = 0) -> GadgetCiphertext:
    """Gadget ciphertext from its rows: q [beta, 2, LQ, N], p [beta, 2, LP, N]
    (or None); ``base2`` > 0 for the power-of-two gadget's rows."""
    return GadgetCiphertext(qp_from_numpy(q, p, device), int(base2))


def galois_key_from_numpy(q, p, gal_el: int, device) -> GaloisKey:
    """Galois key from its gadget rows and its Galois element."""
    return GaloisKey(gadget_from_numpy(q, p, device), int(gal_el))


def evaluation_key_set_from_numpy(device, rlk=None,
                                  galois_keys=None) -> EvaluationKeySet:
    """An evaluation-key set from the (q, p) rows of its relinearization
    key (or None) and a Galois key set: ``galois_keys`` maps each Galois
    element to its (q, p) gadget rows, at whatever level each key was
    made."""
    return EvaluationKeySet(
        relinearization_key=(None if rlk is None
                             else relinearization_key_from_numpy(*rlk, device)),
        galois_keys={int(g): galois_key_from_numpy(q, p, g, device)
                     for g, (q, p) in (galois_keys or {}).items()})


def linear_transformation_from_numpy(vec, n1: int, level_q: int, scale,
                                     slots: int, device) -> LinearTransformation:
    """An encoded linear transformation: ``vec`` maps each diagonal index
    to the (q, p) residues of its encoded diagonal; the scale (a Fraction
    for CKKS, an int for BGV) is carried as it is."""
    return LinearTransformation(
        vec={int(k): qp_from_numpy(q, p, device) for k, (q, p) in vec.items()},
        n1=int(n1), level_q=int(level_q), scale=scale, slots=int(slots))


def rgsw_from_numpy(c0, c1, device):
    """RGSW ciphertext from its two gadget halves, each a (q, p) pair of
    row arrays as :func:`gadget_from_numpy` takes them."""
    return RgswCiphertext(gadget_from_numpy(*c0, device),
                          gadget_from_numpy(*c1, device))


def blind_rotation_keys_from_numpy(brk, galois_keys, device):
    """A whole blind-rotation key set: ``brk`` lists, per LWE secret
    coefficient, the (c0, c1) halves of its RGSW key as
    :func:`rgsw_from_numpy` takes them (None where a key is left out);
    ``galois_keys`` maps each Galois element to its (q, p) rows."""
    keys = [None if k is None else rgsw_from_numpy(*k, device) for k in brk]
    return BlindRotationKeySet(
        brk=keys, evk=evaluation_key_set_from_numpy(device, galois_keys=galois_keys))


def public_key_from_numpy(q, p, device) -> PublicKey:
    """Public key from its QP parts: q [2, LQ, N], p [2, LP, N]."""
    return PublicKey(qp_from_numpy(q, p, device))


def evaluation_key_from_numpy(q, p, device, base2: int = 0) -> EvaluationKey:
    """Evaluation key from its gadget rows: q [beta, 2, LQ, N], p [beta, 2, LP, N]
    (``base2`` > 0: the power-of-two gadget's rows)."""
    return EvaluationKey(gadget_from_numpy(q, p, device, base2))


def parameters_literal_from_json(text: str) -> ParametersLiteral:
    """The port's literal of either package's ``ParametersLiteral.to_json``
    text: a BGV literal when the text has ``t``, a CKKS one when it has
    ``log_default_scale``, else the RLWE literal."""
    keys = json.loads(text)
    cls = (bgv.ParametersLiteral if "t" in keys
           else ckks.ParametersLiteral if "log_default_scale" in keys
           else ParametersLiteral)
    return cls.from_json(text)


def ring_switching_keys_from_numpy(params, down, up, device) -> RingSwitchingKeys:
    """Ring-switching keys: ``params`` maps each logN to the port's
    parameters, ``down`` / ``up`` map each logN but the least to the (q, p)
    gadget rows of its evaluation key. (The domain switcher's ring-swap
    keys are plain evaluation keys: :func:`evaluation_key_from_numpy`.)"""
    return RingSwitchingKeys(
        dict(params),
        {int(l): evaluation_key_from_numpy(*rows, device) for l, rows in down.items()},
        {int(l): evaluation_key_from_numpy(*rows, device) for l, rows in up.items()})


def bootstrapping_keys_from_numpy(dense_to_sparse, sparse_to_dense,
                                  device) -> BootstrappingKeys:
    """The bootstrap's encapsulation keys from the (q, p) gadget rows of
    its two evaluation keys (either may be None: no encapsulation)."""
    def evk(rows):
        return None if rows is None else evaluation_key_from_numpy(*rows, device)
    return BootstrappingKeys(evk_dense_to_sparse=evk(dense_to_sparse),
                             evk_sparse_to_dense=evk(sparse_to_dense))


def compressed_gadget_from_numpy(q, p, seed: bytes, device) -> CompressedGadgetCiphertext:
    """Compressed gadget ciphertext from its c0 rows (q [beta, LQ, N],
    p [beta, LP, N]) and its seed."""
    return CompressedGadgetCiphertext(qp_from_numpy(q, p, device), bytes(seed))


def shamir_polynomial_from_numpy(coeffs, device) -> ShamirPolynomial:
    """Shamir polynomial from its coefficients, each a (q, p) pair."""
    return ShamirPolynomial([qp_from_numpy(q, p, device) for q, p in coeffs])


def share_from_numpy(share, device):
    """A protocol share (a residue array, a QPPoly holding numpy arrays, or
    a list / tuple of them, nested) with every array moved to ``device`` as
    int64 tensors; the structure is kept."""
    if isinstance(share, QPPoly):
        return qp_from_numpy(share.q, share.p, device)
    if isinstance(share, (list, tuple)):
        return type(share)(share_from_numpy(x, device) for x in share)
    return to_torch(share, device)


def share_to_numpy(share):
    """The inverse of :func:`share_from_numpy`: tensors to numpy uint64."""
    if isinstance(share, QPPoly):
        return QPPoly(*qp_to_numpy(share))
    if isinstance(share, (list, tuple)):
        return type(share)(share_to_numpy(x) for x in share)
    return to_numpy(share)
