"""CKKS encoder: canonical embedding C^{N/2} ↔ R = Z[X]/(X^N+1).

Counterpart of :mod:`lattigo_tpu.schemes.ckks.encoder`. The embedding is a
single length-2N FFT on the host (numpy, f64, the same code as the
reference, so the same floats):

    slot_j = m(ζ^{e_j}),  e_j = 5^j mod 2N  (row-0 exponents)
    encode: m_k = (2/N)·Re( FFT_{2N}(A)[k] ),  A[e_j] = v_j
    decode: v_j = (2N·IFFT_{2N}(m))[e_j]

Only the lift of the rounded coefficients to residues and the NTT run on
the device. Decoding brings the INTT's output back to the host and
CRT-reconstructs each polynomial of a batch with Python integers
(:meth:`Ring.to_int_coeffs`, one polynomial at a time).

The 5^j slot order makes rotation by k the Galois element 5^k and
conjugation the element 2N−1.

:class:`CIEncoder` is the conjugate-invariant ring's encoder: N real slots
at ring degree N, evaluated at the 5-orbit of the 4N-th roots with one
length-4N FFT.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import torch

from lattigo_tpu_torch.ring import sampling
from lattigo_tpu_torch.ring.ring import CONJUGATE_INVARIANT, STANDARD, u64_tensor
from lattigo_tpu_torch.rlwe.elements import Plaintext
from lattigo_tpu_torch.schemes.ckks.params import Parameters


@functools.lru_cache(maxsize=None)
def _rot_group_exponents(n: int) -> np.ndarray:
    """e_j = 5^j mod 2N for j in [0, N/2)."""
    two_n = 2 * n
    e = np.zeros(n // 2, dtype=np.int64)
    cur = 1
    for j in range(n // 2):
        e[j] = cur
        cur = cur * 5 % two_n
    return e


@functools.lru_cache(maxsize=None)
def _rot_group_exponents_ci(n: int) -> np.ndarray:
    """e_k = 5^k mod 4N for k in [0, N) (CI ring: 4N-th roots)."""
    four_n = 4 * n
    e = np.zeros(n, dtype=np.int64)
    cur = 1
    for k in range(n):
        e[k] = cur
        cur = cur * 5 % four_n
    return e


class Encoder:
    """Canonical-embedding encoder (f64 on the host)."""

    def __init__(self, params: Parameters):
        if params.ring_type != STANDARD:
            raise ValueError("Encoder takes a standard ring; the "
                             "conjugate-invariant ring has CIEncoder")
        self.params = params
        self.exponents = _rot_group_exponents(params.n)

    # -- embedding (host, f64) -------------------------------------------------

    def _padded_slots(self, values) -> np.ndarray:
        slots = self.params.max_slots
        v = np.asarray(values, dtype=np.complex128)
        if v.shape[-1] < slots:
            pad = np.zeros(v.shape[:-1] + (slots - v.shape[-1],), np.complex128)
            v = np.concatenate([v, pad], axis=-1)
        return v

    def embed_to_coeffs(self, values) -> np.ndarray:
        """complex v[..., ≤N/2] → real coeffs f64[..., N] (unscaled)."""
        p = self.params
        v = self._padded_slots(values)
        a = np.zeros(v.shape[:-1] + (2 * p.n,), dtype=np.complex128)
        a[..., self.exponents] = v
        return (2.0 / p.n) * np.fft.fft(a, axis=-1)[..., : p.n].real

    def coeffs_to_slots(self, coeffs) -> np.ndarray:
        """real coeffs f64[..., N] → complex slots[..., N/2]."""
        p = self.params
        m = np.asarray(coeffs, dtype=np.float64)
        pad = np.zeros(m.shape[:-1] + (p.n,), dtype=np.float64)
        spec = np.fft.ifft(np.concatenate([m, pad], axis=-1), axis=-1) * (2 * p.n)
        return spec[..., self.exponents]

    # -- RNS lifts ---------------------------------------------------------------

    def _lift_ints(self, ints: np.ndarray, level: int) -> torch.Tensor:
        """Signed integer coeffs → residues int64[..., level+1, N] on the
        device: int64 coefficients are reduced there, Python integers
        (object arrays, for scales past 2^52) on the host."""
        p = self.params
        if ints.dtype == object:
            out = np.stack([np.mod(ints, q) for q in p.q_moduli[: level + 1]],
                           axis=-2).astype(np.uint64)
            return u64_tensor(out, p.device)
        return sampling.lift_signed(p.ring_q, torch.from_numpy(ints), level)

    def _int_coeffs(self, pt: Plaintext) -> tuple[list[list[int]], tuple]:
        """Centered integer coefficients of every polynomial of pt, and the
        batch shape they came in."""
        p = self.params
        v = pt.value
        if pt.is_ntt:
            v = p.ring_q.intt(v, pt.level)
        batch = tuple(v.shape[:-2])
        flat = v.reshape((-1,) + tuple(v.shape[-2:])).cpu()
        return [p.ring_q.to_int_coeffs(x, pt.level, centered=True)
                for x in flat], batch

    # -- public API --------------------------------------------------------------

    def encode(self, values, level: int | None = None,
               scale: Fraction | None = None) -> Plaintext:
        p = self.params
        level = p.max_level if level is None else level
        scale = p.default_scale_fraction if scale is None else Fraction(scale)
        coeffs = self.embed_to_coeffs(values) * float(scale)
        if np.max(np.abs(coeffs), initial=0.0) < 2**52:
            ints = np.round(coeffs).astype(np.int64)
        else:  # big-int path for very large scales
            ints = np.vectorize(lambda x: int(round(x)), otypes=[object])(coeffs)
        pt_q = self._lift_ints(ints, level)
        return Plaintext(value=p.ring_q.ntt(pt_q, level), is_ntt=True, scale=scale)

    def decode(self, pt: Plaintext) -> np.ndarray:
        """Slots complex128[..., N/2] on the host (a batch loops over its
        polynomials for the CRT)."""
        polys, batch = self._int_coeffs(pt)
        coeffs = np.array([[float(x) for x in c] for c in polys]) / float(pt.scale)
        return self.coeffs_to_slots(coeffs.reshape(batch + (self.params.n,)))

    def decode_public(self, pt: Plaintext, log_prec: float = 0) -> np.ndarray:
        """Decode for publication: slots rounded to ``log_prec`` fractional
        bits so the decryption noise is not exposed (``log_prec == 0``
        skips the rounding)."""
        v = self.decode(pt)
        if log_prec:
            s = 2.0 ** log_prec
            v = (np.round(v.real * s) + 1j * np.round(v.imag * s)) / s
        return v


class CIEncoder(Encoder):
    """Real-slot encoder of the conjugate-invariant ring: N real slots at
    ring degree N. CI elements take real values on the 5-orbit of the
    4N-th roots, since p(ζ) = p(ζ^{-1}). The coefficient convention is
    :mod:`lattigo_tpu_torch.ring.ntt_ci`'s: (c_0…c_{N−1}) ↦ c_0 + Σ c_j
    (X^j + X^{−j}). Encoding, the RNS lift and decoding are the standard
    encoder's, around this embedding; decoded slots are real."""

    def __init__(self, params: Parameters):
        if params.ring_type != CONJUGATE_INVARIANT:
            raise ValueError("CIEncoder takes a conjugate-invariant ring")
        self.params = params
        self.exponents = _rot_group_exponents_ci(params.n)

    def embed_to_coeffs(self, values) -> np.ndarray:
        """real v[..., ≤N] → CI coeffs f64[..., N] (unscaled):
        p̃_j = (1/N)·Re Σ_k v_k ζ^{e_k j}."""
        n = self.params.n
        v = np.real(np.asarray(values, dtype=np.complex128))
        if v.shape[-1] < n:
            v = np.concatenate([v, np.zeros(v.shape[:-1] + (n - v.shape[-1],))],
                               axis=-1)
        a = np.zeros(v.shape[:-1] + (4 * n,), dtype=np.complex128)
        a[..., self.exponents] = v
        return (1.0 / n) * np.fft.fft(a, axis=-1)[..., :n].real

    def coeffs_to_slots(self, coeffs) -> np.ndarray:
        """CI coeffs f64[..., N] → real slots[..., N]: the negacyclic
        unfolding p̃_j = c_j, p̃_{2N−j} = −c_j, then a length-4N FFT."""
        n = self.params.n
        c = np.asarray(coeffs, dtype=np.float64)
        full = np.zeros(c.shape[:-1] + (4 * n,), dtype=np.float64)
        full[..., :n] = c
        full[..., n + 1: 2 * n] = -c[..., 1:][..., ::-1]
        spec = np.fft.ifft(full, axis=-1) * (4 * n)
        return spec[..., self.exponents].real


class PrecisionEncoder(Encoder):
    """~106-bit canonical-embedding encoder: the same length-2N FFT in
    double-double arithmetic (:mod:`lattigo_tpu_torch.utils.ddarith`) with
    exact Fraction scale handling. ``decode_dd`` returns the slots as a
    (hi, lo) pair of complex arrays."""

    def encode(self, values, level: int | None = None,
               scale: Fraction | None = None) -> Plaintext:
        from lattigo_tpu_torch.utils import ddarith as dd
        p = self.params
        level = p.max_level if level is None else level
        scale = p.default_scale_fraction if scale is None else Fraction(scale)
        v = self._padded_slots(values)
        ar = np.zeros(v.shape[:-1] + (2 * p.n,))
        ai = np.zeros_like(ar)
        ar[..., self.exponents] = v.real
        ai[..., self.exponents] = v.imag
        rh, rl, _, _ = dd.fft_dd(ar, np.zeros_like(ar), ai, np.zeros_like(ai))
        # coeff_k = (2/N)·Re(FFT[k]); quantise at `scale` exactly
        fac = Fraction(2, p.n) * scale
        flat_h = rh[..., : p.n].reshape(-1)
        flat_l = rl[..., : p.n].reshape(-1)
        ints = np.empty(flat_h.shape, dtype=object)
        for i in range(flat_h.shape[0]):
            ints[i] = round(dd.dd_to_fraction(flat_h[i], flat_l[i]) * fac)
        ints = ints.reshape(rh.shape[:-1] + (p.n,))
        pt_q = self._lift_ints(ints, level)
        return Plaintext(value=p.ring_q.ntt(pt_q, level), is_ntt=True, scale=scale)

    def decode_dd(self, pt: Plaintext) -> tuple[np.ndarray, np.ndarray]:
        """→ (slots_hi, slots_lo): complex128 pair, hi + lo ≈ true slots."""
        from lattigo_tpu_torch.utils import ddarith as dd
        p = self.params
        polys, batch = self._int_coeffs(pt)
        inv_scale = 1 / Fraction(pt.scale)
        ch = np.empty((len(polys), p.n))
        cl = np.empty((len(polys), p.n))
        for b, ints in enumerate(polys):
            for i in range(p.n):
                f = int(ints[i]) * inv_scale
                ch[b, i] = float(f)
                cl[b, i] = float(f - Fraction(ch[b, i]))
        two_n = 2 * p.n
        zeros = np.zeros((len(polys), two_n - p.n))
        mh = np.concatenate([ch, zeros], axis=-1)
        ml = np.concatenate([cl, zeros], axis=-1)
        rh, rl, ih, il = dd.fft_dd(mh, ml, np.zeros_like(mh), np.zeros_like(mh),
                                   inverse=True)
        # slots = 2N·IFFT[e_j]
        e = self.exponents
        hi = (two_n * rh[..., e]) + 1j * (two_n * ih[..., e])
        lo = (two_n * rl[..., e]) + 1j * (two_n * il[..., e])
        shape = batch + (p.max_slots,)
        return hi.reshape(shape), lo.reshape(shape)

    def decode(self, pt: Plaintext) -> np.ndarray:
        hi, lo = self.decode_dd(pt)
        return hi + lo
