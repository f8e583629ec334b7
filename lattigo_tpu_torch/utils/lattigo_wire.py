"""Lattigo's binary wire format for the port's objects.

Counterpart of :mod:`lattigo_tpu.utils.lattigo_wire`: the Go library's
``WriteTo`` / ``ReadFrom`` byte layout, so keys and ciphertexts pass between
the port, the JAX package and a Go Lattigo process. The same object gives
the same bytes in both packages.

Byte layout (every integer little-endian):

- ``structs.Vector[uint64]``: u64 length, then the raw u64 data.
- ``structs.Matrix[T]``: u64 #rows, then each row as a Vector.
- ``ring.Poly``: its coefficient Matrix[uint64] (one row per limb).
- ``ringqp.Poly``: the Q Poly then the P Poly; an absent basis is a 0-row
  matrix.
- ``rlwe.Element``: u8 has-metadata flag, the fixed-width MetaData JSON,
  then Vector[Poly].
- ``rlwe.MetaData``: JSON with hex-string booleans and 39-digit
  scientific big-float scales, always :data:`METADATA_SIZE` bytes.
- ``rlwe.SecretKey``: its ringqp.Poly; ``rlwe.PublicKey``: a Vector of 2.
- ``rlwe.GadgetCiphertext``: u64 BaseTwoDecomposition, then
  Matrix[Vector[ringqp.Poly]]: [beta][1] for the RNS gadget, [limb][digits
  of that limb] for the power-of-two gadget.
- ``rlwe.EvaluationKey``: its GadgetCiphertext; ``rlwe.GaloisKey``: u64
  Galois element, u64 NthRoot, then the EvaluationKey.

The port carries residues as int64 tensors holding u64 bit patterns: a
tensor goes out as ``.cpu().numpy().view(np.uint64)`` and comes back with
``np.frombuffer(..., "<u8").view(np.int64)`` onto the device the caller
names (``device``; CUDA unless the caller names another). NTT- and
Montgomery-domain polynomials are written as they are.
"""

from __future__ import annotations

import json
import struct as _struct
from decimal import ROUND_HALF_EVEN, Decimal, localcontext
from fractions import Fraction
from typing import Any

import numpy as np
import torch

from lattigo_tpu_torch.device import resolve_device
from lattigo_tpu_torch.ring.ringqp import QPPoly
from lattigo_tpu_torch.rlwe.elements import Ciphertext, Plaintext
from lattigo_tpu_torch.rlwe.keys import (
    EvaluationKey, GadgetCiphertext, GaloisKey, PublicKey, RelinearizationKey,
    SecretKey,
)

# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def _w_u64(x: int) -> bytes:
    return _struct.pack("<Q", x)


def _r_u64(b: memoryview, off: int) -> tuple[int, int]:
    return _struct.unpack_from("<Q", b, off)[0], off + 8


def write_u64_vector(v: np.ndarray) -> bytes:
    """structs.Vector[uint64]: u64 length, then the data."""
    v = np.ascontiguousarray(np.asarray(v, dtype="<u8"))
    if v.ndim != 1:
        raise ValueError("write_u64_vector takes a 1-D array")
    return _w_u64(v.shape[0]) + v.tobytes()


def read_u64_vector(b: memoryview, off: int) -> tuple[np.ndarray, int]:
    ln, off = _r_u64(b, off)
    v = np.frombuffer(b, dtype="<u8", count=ln, offset=off).copy()
    return v, off + 8 * ln


def write_poly(coeffs: np.ndarray) -> bytes:
    """ring.Poly = Matrix[uint64]: u64 #limbs, then one Vector per limb
    (written as one block: each row's length word, then its data)."""
    coeffs = np.atleast_2d(np.asarray(coeffs, dtype=np.uint64))
    rows, n = coeffs.shape
    block = np.empty((rows, n + 1), dtype="<u8")
    block[:, 0] = n
    block[:, 1:] = coeffs
    return _w_u64(rows) + block.tobytes()


def read_poly(b: memoryview, off: int) -> tuple[np.ndarray, int]:
    """Inverse of :func:`write_poly`, read as one block; rows of unequal
    length (no polynomial has them) raise ``ValueError``."""
    rows, off = _r_u64(b, off)
    if rows == 0:
        return np.zeros((0, 0), dtype=np.uint64), off
    n, _ = _r_u64(b, off)
    end = off + 8 * rows * (n + 1)
    if end > len(b):
        raise ValueError("a poly's rows of unequal length, or cut short")
    block = np.frombuffer(b, dtype="<u8", count=rows * (n + 1),
                          offset=off).reshape(rows, n + 1)
    if not (block[:, 0] == n).all():
        raise ValueError("a poly's rows of unequal length")
    return block[:, 1:].astype(np.uint64), end


def write_qp_poly(q: np.ndarray | None, p: np.ndarray | None) -> bytes:
    """ringqp.Poly: Q coefficients then P coefficients; an absent basis is
    an empty matrix."""
    empty = np.zeros((0, 0), dtype=np.uint64)
    return write_poly(q if q is not None else empty) + write_poly(
        p if p is not None else empty)


def read_qp_poly(b: memoryview, off: int):
    q, off = read_poly(b, off)
    p, off = read_poly(b, off)
    return (q if q.size else None), (p if p.size else None), off


# ---------------------------------------------------------------------------
# MetaData (fixed-width JSON)
# ---------------------------------------------------------------------------

SCALE_PRECISION_LOG10 = 39  # ceil(128 / log2(10))


def _go_float_text(x) -> str:
    """Go's big.Float.Text('e', 39): 'd.<39 digits>e±dd'.

    Go rounds its 128-bit binary mantissa to 39 decimal digits; the values
    here are exact rationals or integers, so rounding the decimal directly
    agrees whenever the value is exact in 128 bits (always so for the
    power-of-two and integer scales used in practice).
    """
    f = Fraction(x)
    if f == 0:
        return "0." + "0" * SCALE_PRECISION_LOG10 + "e+00"
    sign = "-" if f < 0 else ""
    f = abs(f)
    with localcontext() as ctx:
        ctx.prec = SCALE_PRECISION_LOG10 + 10
        d = Decimal(f.numerator) / Decimal(f.denominator)
        exp = d.adjusted()
        mant = d.scaleb(-exp).quantize(
            Decimal(1).scaleb(-SCALE_PRECISION_LOG10), rounding=ROUND_HALF_EVEN)
        if mant >= 10:  # rounding overflowed to the next decade
            mant = (mant / 10).quantize(
                Decimal(1).scaleb(-SCALE_PRECISION_LOG10),
                rounding=ROUND_HALF_EVEN)
            exp += 1
    return f"{sign}{mant}e{exp:+03d}"


def _scale_json(value, mod: int | None) -> dict:
    return {"Value": _go_float_text(value), "Mod": _go_float_text(mod or 0)}


def _hex8(flag: bool | int) -> str:
    return f"0x{int(flag):02x}"


# Scale = 21 + 2·(39 + 6) = 111, PlaintextMetaData = 84 + Scale,
# CiphertextMetaData = 38, MetaData = 44 + both
METADATA_SIZE = 44 + (84 + 111) + 38  # = 277 bytes, always


def write_metadata(*, scale=1.0, scale_mod: int | None = None,
                   log_dimensions: tuple[int, int] = (0, 0),
                   is_batched: bool = True, is_bit_reversed: bool = False,
                   is_ntt: bool = True, is_montgomery: bool = False) -> bytes:
    """rlwe.MetaData: fixed-width JSON."""
    rows, cols = log_dimensions
    meta = {
        "PlaintextMetaData": {
            "Scale": _scale_json(scale, scale_mod),
            "IsBatched": _hex8(is_batched),
            "IsBitReversed": _hex8(is_bit_reversed),
            "LogDimensions": [_hex8(rows & 0xFF), _hex8(cols & 0xFF)],
        },
        "CiphertextMetaData": {
            "IsNTT": _hex8(is_ntt),
            "IsMontgomery": _hex8(is_montgomery),
        },
    }
    raw = json.dumps(meta, separators=(",", ":")).encode()
    if len(raw) != METADATA_SIZE:
        raise ValueError(f"metadata of {len(raw)} bytes, not {METADATA_SIZE}")
    return raw


def read_metadata(b: memoryview, off: int) -> tuple[dict, int]:
    meta = json.loads(bytes(b[off:off + METADATA_SIZE]))
    pt, ct = meta["PlaintextMetaData"], meta["CiphertextMetaData"]

    def _num(s: str):
        f = Fraction(Decimal(s))
        return int(f) if f.denominator == 1 else f

    mod = _num(pt["Scale"]["Mod"])
    out = {
        "scale": _num(pt["Scale"]["Value"]),
        "scale_mod": int(mod) if mod else None,
        "is_batched": int(pt["IsBatched"], 16) == 1,
        "is_bit_reversed": int(pt["IsBitReversed"], 16) == 1,
        "log_dimensions": (int(pt["LogDimensions"][0], 16),
                           int(pt["LogDimensions"][1], 16)),
        "is_ntt": int(ct["IsNTT"], 16) == 1,
        "is_montgomery": int(ct["IsMontgomery"], 16) == 1,
    }
    return out, off + METADATA_SIZE


# ---------------------------------------------------------------------------
# tensors <-> u64 arrays
# ---------------------------------------------------------------------------


def _u64(t: torch.Tensor | None) -> np.ndarray | None:
    """int64 tensor on any device -> uint64 array with the same bits."""
    if t is None:
        return None
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def _tensor(a: np.ndarray | None, device) -> torch.Tensor | None:
    """uint64 array -> int64 tensor with the same bits on ``device``."""
    if a is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.uint64)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a.view(np.int64)).to(device)


# ---------------------------------------------------------------------------
# Elements (Ciphertext / Plaintext)
# ---------------------------------------------------------------------------


def write_element(polys: np.ndarray, **meta) -> bytes:
    """rlwe.Element[ring.Poly]: u8 flag + MetaData + Vector[Poly];
    ``polys`` uint64[degree+1, limbs, N]."""
    polys = np.asarray(polys, dtype=np.uint64)
    if polys.ndim == 2:
        polys = polys[None]
    out = [b"\x01", write_metadata(**meta), _w_u64(polys.shape[0])]
    for p in polys:
        out.append(write_poly(p))
    return b"".join(out)


def read_element(b: bytes | memoryview, off: int = 0):
    """(value uint64[degree+1, limbs, N], metadata dict, next offset)."""
    b = memoryview(b)
    has_meta = b[off]
    off += 1
    meta: dict[str, Any] = {}
    if has_meta:
        meta, off = read_metadata(b, off)
    count, off = _r_u64(b, off)
    polys = []
    for _ in range(count):
        p, off = read_poly(b, off)
        polys.append(p)
    return np.stack(polys), meta, off


def ciphertext_to_bytes(ct, *, scale=None, scale_mod=None,
                        log_dimensions=(0, 0), is_batched=True) -> bytes:
    """One (not batched) Ciphertext or Plaintext as an rlwe.Element."""
    value = _u64(ct.value)
    if value.ndim == 2:           # plaintext
        value = value[None]
    if value.ndim != 3:
        raise ValueError("a batch of ciphertexts: write each element")
    return write_element(
        value, scale=ct.scale if scale is None else scale,
        scale_mod=scale_mod, log_dimensions=log_dimensions,
        is_batched=is_batched, is_ntt=ct.is_ntt, is_montgomery=ct.is_montgomery)


def ciphertext_from_bytes(data: bytes, device=None):
    """A Ciphertext (degree ≥ 1) or a Plaintext (degree 0) on ``device``;
    an integral scale comes back as an int, any other as a Fraction."""
    value, meta, _ = read_element(data)
    v = _tensor(value, resolve_device(device))
    kw = dict(is_ntt=meta.get("is_ntt", True),
              is_montgomery=meta.get("is_montgomery", False),
              scale=meta.get("scale", 1.0))
    if v.shape[0] == 1:
        return Plaintext(value=v[0], **kw)
    return Ciphertext(value=v, **kw)


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


def secret_key_to_bytes(sk: SecretKey) -> bytes:
    """The NTT + Montgomery ringqp.Poly of s."""
    return write_qp_poly(_u64(sk.value.q), _u64(sk.value.p))


def secret_key_from_bytes(data: bytes, device=None) -> SecretKey:
    q, p, _ = read_qp_poly(memoryview(data), 0)
    dev = resolve_device(device)
    return SecretKey(QPPoly(_tensor(q, dev), _tensor(p, dev)))


def _write_vector_qp(qs, ps) -> bytes:
    """Vector[ringqp.Poly]."""
    out = [_w_u64(len(qs))]
    for q, p in zip(qs, ps):
        out.append(write_qp_poly(q, p))
    return b"".join(out)


def _read_vector_qp(b: memoryview, off: int):
    ln, off = _r_u64(b, off)
    qs, ps = [], []
    for _ in range(ln):
        q, p, off = read_qp_poly(b, off)
        qs.append(q)
        ps.append(p)
    return qs, ps, off


def public_key_to_bytes(pk: PublicKey) -> bytes:
    """A Vector of the two ringqp.Polys (p0, p1)."""
    q, p = _u64(pk.value.q), _u64(pk.value.p)
    return _write_vector_qp([q[i] for i in range(q.shape[0])],
                            [None if p is None else p[i] for i in range(q.shape[0])])


def public_key_from_bytes(data: bytes, device=None) -> PublicKey:
    qs, ps, _ = _read_vector_qp(memoryview(data), 0)
    dev = resolve_device(device)
    p = None if ps[0] is None else np.stack(ps)
    return PublicKey(QPPoly(_tensor(np.stack(qs), dev), _tensor(p, dev)))


def _base2_digit_counts(q_moduli, base2: int) -> list[int]:
    """Digits of each limb in the power-of-two gadget: ceil(log2 q_i / w)."""
    return [-(-((q - 1).bit_length()) // base2) for q in q_moduli]


def gadget_ciphertext_to_bytes(g: GadgetCiphertext, q_moduli=None) -> bytes:
    """u64 base2, then Matrix[Vector[ringqp.Poly]].

    The port's rows value.q [rows, 2, LQ, N] map to Lattigo's matrix: with
    base2 = 0 it is [beta][1]; with base2 = w > 0 the rows (limb i, digit
    j) at i·max_digits + j become matrix row i with exactly digits_i
    columns, the zero-padded rows past digits_i left out. ``q_moduli`` (the
    Q chain up to the gadget's level) is needed for base2 > 0, to count
    each limb's digits.
    """
    q, p = _u64(g.value.q), _u64(g.value.p)
    base2 = int(g.base2)
    rows, deg = q.shape[0], q.shape[1]

    def entry(r: int) -> bytes:
        return _write_vector_qp([q[r, d] for d in range(deg)],
                                [None if p is None else p[r, d] for d in range(deg)])

    out = [_w_u64(base2)]
    if base2 > 0:
        if q_moduli is None:
            raise ValueError(
                "base-2^w gadget serialization needs q_moduli (the Q chain "
                "up to the gadget's level) to recover per-limb digit counts")
        lq = q.shape[-2]
        digits = _base2_digit_counts(q_moduli[:lq], base2)
        max_dig = rows // lq
        out.append(_w_u64(lq))
        for i in range(lq):
            out.append(_w_u64(digits[i]))
            out.extend(entry(i * max_dig + j) for j in range(digits[i]))
        return b"".join(out)
    out.append(_w_u64(rows))
    for r in range(rows):
        out.append(_w_u64(1))       # one column per row group
        out.append(entry(r))
    return b"".join(out)


def gadget_ciphertext_from_bytes(data: bytes, device=None):
    """Inverse of :func:`gadget_ciphertext_to_bytes`: (gadget, next offset).
    For base2 > 0 each limb's rows are padded back to the flat (limb,
    digit) layout with zero rows (the product never reads them: those
    digits are zero)."""
    b = memoryview(data)
    base2, off = _r_u64(b, 0)
    rows, off = _r_u64(b, off)
    row_q, row_p, counts = [], [], []
    for _ in range(rows):
        cols, off = _r_u64(b, off)
        counts.append(cols)
        if base2 == 0 and cols != 1:
            raise ValueError("unsupported gadget matrix layout")
        for _ in range(cols):
            qs, ps, off = _read_vector_qp(b, off)
            row_q.append(np.stack(qs))
            row_p.append(None if ps[0] is None else np.stack(ps))
    if base2 > 0:
        max_dig = max(counts)
        pad_q, pad_p, k = [], [], 0
        for c in counts:
            for j in range(max_dig):
                if j < c:
                    pad_q.append(row_q[k])
                    pad_p.append(row_p[k])
                    k += 1
                else:
                    pad_q.append(np.zeros_like(pad_q[-1]))
                    pad_p.append(None if pad_p[-1] is None
                                 else np.zeros_like(pad_p[-1]))
        row_q, row_p = pad_q, pad_p
    dev = resolve_device(device)
    p = None if row_p[0] is None else np.stack(row_p)
    return GadgetCiphertext(QPPoly(_tensor(np.stack(row_q), dev), _tensor(p, dev)),
                            int(base2)), off


def evaluation_key_to_bytes(evk, q_moduli=None) -> bytes:
    """The key's gadget ciphertext (``q_moduli`` needed for base2 > 0)."""
    return gadget_ciphertext_to_bytes(evk.gadget, q_moduli)


def evaluation_key_from_bytes(data: bytes, device=None) -> EvaluationKey:
    return EvaluationKey(gadget_ciphertext_from_bytes(data, device)[0])


def relinearization_key_to_bytes(rlk, q_moduli=None) -> bytes:
    return evaluation_key_to_bytes(rlk, q_moduli)


def relinearization_key_from_bytes(data: bytes, device=None) -> RelinearizationKey:
    return RelinearizationKey(gadget_ciphertext_from_bytes(data, device)[0])


def galois_key_to_bytes(gk: GaloisKey, nth_root: int) -> bytes:
    """u64 Galois element, u64 NthRoot, then the evaluation key."""
    return (_w_u64(int(gk.gal_el)) + _w_u64(int(nth_root))
            + gadget_ciphertext_to_bytes(gk.gadget))


def galois_key_from_bytes(data: bytes, device=None) -> GaloisKey:
    b = memoryview(data)
    gal_el, off = _r_u64(b, 0)
    _nth_root, off = _r_u64(b, off)
    g, _ = gadget_ciphertext_from_bytes(bytes(b[off:]), device)
    return GaloisKey(g, int(gal_el))
