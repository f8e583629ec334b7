"""Vectorized double-double (~106-bit) arithmetic and FFT on the host.

The port's own copy of :mod:`lattigo_tpu.utils.ddarith` (plain numpy, the
same operations in the same order, so the same bits). It supports the CKKS
high-precision encoder (the analog of the reference's big-float embedding,
``schemes/ckks/encoder.go:342 embedArbitrary``): numpy arrays of (hi, lo)
f64 pairs give ~2^-105 relative error at numpy speed — an O(N log N)
big-float FFT without per-element mpmath overhead.

Algorithms: Dekker/Knuth error-free transforms + Bailey double-double
add/mul; iterative radix-2 DIT FFT with double-double twiddles generated
once per length via mpmath (imported when a table is first built).
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np

_SPLITTER = 134217729.0  # 2^27 + 1


def two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def quick_two_sum(a, b):
    """Requires |a| ≥ |b| (or a = 0)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    c = _SPLITTER * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def dd_add(xh, xl, yh, yl):
    s, e = two_sum(xh, yh)
    e = e + xl + yl
    return quick_two_sum(s, e)


def dd_neg(xh, xl):
    return -xh, -xl


def dd_sub(xh, xl, yh, yl):
    return dd_add(xh, xl, -yh, -yl)


def dd_mul(xh, xl, yh, yl):
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return quick_two_sum(p, e)


def dd_from_fraction(f: Fraction) -> tuple[float, float]:
    hi = float(f)
    lo = float(f - Fraction(hi))
    return hi, lo


def dd_from_int_array(ints) -> tuple[np.ndarray, np.ndarray]:
    """Object array of Python ints → (hi, lo) with ~106-bit precision."""
    flat = np.asarray(ints, dtype=object).ravel()
    hi = np.empty(flat.shape, dtype=np.float64)
    lo = np.empty(flat.shape, dtype=np.float64)
    for i, x in enumerate(flat):
        h = float(x)
        hi[i] = h
        lo[i] = float(x - int(h))
    shape = np.asarray(ints, dtype=object).shape
    return hi.reshape(shape), lo.reshape(shape)


def dd_to_fraction(hi: float, lo: float) -> Fraction:
    return Fraction(hi) + Fraction(lo)


# -- complex double-double FFT ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def _twiddles_dd(n: int, sign: int):
    """(hi, lo) of re/im of e^{sign·2πi·k/n}, k < n/2, via mpmath."""
    from mpmath import mp, mpf, cos, sin, pi
    with mp.workprec(160):
        re_h = np.empty(n // 2)
        re_l = np.empty(n // 2)
        im_h = np.empty(n // 2)
        im_l = np.empty(n // 2)
        for k in range(n // 2):
            ang = 2 * pi * mpf(k) / n
            c, s = cos(ang), sin(ang) * sign
            ch = float(c)
            sh = float(s)
            re_h[k], re_l[k] = ch, float(c - mpf(ch))
            im_h[k], im_l[k] = sh, float(s - mpf(sh))
    return re_h, re_l, im_h, im_l


@functools.lru_cache(maxsize=None)
def _bit_rev_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for _ in range(bits):
        rev = (rev << 1) | (idx & 1)
        idx >>= 1
    return rev


def fft_dd(re_h, re_l, im_h, im_l, inverse: bool = False):
    """In-place-style radix-2 DIT FFT over the LAST axis (length 2^k) in
    complex double-double. Forward uses e^{-2πik/n}; inverse e^{+2πik/n}
    and divides by n."""
    n = re_h.shape[-1]
    assert n & (n - 1) == 0
    perm = _bit_rev_perm(n)
    xs = [np.ascontiguousarray(a[..., perm], dtype=np.float64)
          for a in (re_h, re_l, im_h, im_l)]
    rh, rl, ih, il = xs
    sign = 1 if inverse else -1
    twr_h, twr_l, twi_h, twi_l = _twiddles_dd(n, sign)

    m = 2
    while m <= n:
        half = m // 2
        stride = n // m
        tw = (twr_h[::stride][:half], twr_l[::stride][:half],
              twi_h[::stride][:half], twi_l[::stride][:half])
        shape = re_h.shape[:-1] + (n // m, m)
        rh4 = rh.reshape(shape)
        rl4 = rl.reshape(shape)
        ih4 = ih.reshape(shape)
        il4 = il.reshape(shape)
        ar_h, ar_l = rh4[..., :half], rl4[..., :half]
        ai_h, ai_l = ih4[..., :half], il4[..., :half]
        br_h, br_l = rh4[..., half:], rl4[..., half:]
        bi_h, bi_l = ih4[..., half:], il4[..., half:]
        wr_h, wr_l, wi_h, wi_l = tw
        # t = w·b  (complex dd mul)
        t1h, t1l = dd_mul(br_h, br_l, wr_h, wr_l)
        t2h, t2l = dd_mul(bi_h, bi_l, wi_h, wi_l)
        tr_h, tr_l = dd_sub(t1h, t1l, t2h, t2l)
        t3h, t3l = dd_mul(br_h, br_l, wi_h, wi_l)
        t4h, t4l = dd_mul(bi_h, bi_l, wr_h, wr_l)
        ti_h, ti_l = dd_add(t3h, t3l, t4h, t4l)
        # butterfly
        nrh, nrl = dd_add(ar_h, ar_l, tr_h, tr_l)
        nih, nil_ = dd_add(ai_h, ai_l, ti_h, ti_l)
        srh, srl = dd_sub(ar_h, ar_l, tr_h, tr_l)
        sih, sil = dd_sub(ai_h, ai_l, ti_h, ti_l)
        rh4[..., :half], rl4[..., :half] = nrh, nrl
        ih4[..., :half], il4[..., :half] = nih, nil_
        rh4[..., half:], rl4[..., half:] = srh, srl
        ih4[..., half:], il4[..., half:] = sih, sil
        m <<= 1

    if inverse:
        inv = 1.0 / n  # n is a power of two: exact f64 scaling
        rh, rl, ih, il = rh * inv, rl * inv, ih * inv, il * inv
    return rh, rl, ih, il
