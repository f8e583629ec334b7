"""64-bit modular arithmetic on ``torch.int64`` tensors.

Counterpart of :mod:`lattigo_tpu.ring.modops`. Torch has almost no uint64
arithmetic, so residues are carried as int64 holding the same 64-bit
pattern. Additions, subtractions and multiplications wrap mod 2^64 in
two's complement exactly as the unsigned ops do; the three places where
signedness matters are handled explicitly:

* right shifts are arithmetic in torch, so every shift of a value that may
  have its top bit set is masked afterwards (:func:`srl`);
* the high word of a 64x64 product is built from masked 32-bit halves
  (:func:`mul_hi`), so wrapped Montgomery quotients ``m = a·b·qinv`` read
  as unsigned;
* unsigned comparisons flip the sign bit first (:func:`ult`).

Every comparison against ``q`` is on values below 2^63 (primes < 2^61,
lazy bound 4q), where the signed order is the unsigned one. Lazy
accumulation margins are derived from 2^63 (:func:`margin_for`).

Conventions follow the reference: ``qinv`` = q^{-1} mod 2^64 (as its int64
bit pattern), ``bred`` = the two words of ⌊2^128/q⌋, "M-form" is a·2^64 mod
q, lazy outputs live in [0, 2q).
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
SIGN = -(1 << 63)
#: Bytes of int64 products :func:`mred_sum` forms at once.
MAC_CHUNK_BYTES = 1 << 30
SMALL_Q_BITS = 30


def srl(x, k: int):
    """Logical right shift of an int64 tensor holding a u64 pattern."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def ult(a, b):
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ SIGN) < (b ^ SIGN)


def margin_for(qmax: int) -> int:
    """How many [0, 2q) terms an int64 accumulator holds below 2^63."""
    return max(1, ((1 << 63) - 1) // (2 * qmax) - 1)


# ---------------------------------------------------------------------------
# Host-side constant generation
# ---------------------------------------------------------------------------

def gen_mred_constant(q: int) -> int:
    """q^{-1} mod 2^64 (unsigned value)."""
    return pow(q, -1, 1 << 64)


def gen_bred_constant(q: int) -> tuple[int, int]:
    """(hi, lo) words of ⌊2^128 / q⌋ (unsigned values)."""
    u = (1 << 128) // q
    return (u >> 64) & 0xFFFFFFFFFFFFFFFF, u & 0xFFFFFFFFFFFFFFFF


# ---------------------------------------------------------------------------
# 128-bit product building blocks
# ---------------------------------------------------------------------------

def mul_hi(a, b):
    """High 64 bits of the unsigned 128-bit product a*b."""
    a0 = a & M32
    a1 = srl(a, 32)
    b0 = b & M32
    b1 = srl(b, 32)
    m00 = a0 * b0
    m01 = a0 * b1
    m10 = a1 * b0
    carry = (srl(m00, 32) + (m01 & M32) + (m10 & M32)) >> 32
    return a1 * b1 + srl(m01, 32) + srl(m10, 32) + carry


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------

def cred(a, q):
    """a mod q for a in [0, 2q)."""
    return torch.where(a >= q, a - q, a)


def bred_add(a, q, bred_hi):
    """a mod q for any 64-bit pattern a (single-word Barrett)."""
    return cred(a - mul_hi(a, bred_hi) * q, q)


def bred_add_lazy(a, q, bred_hi):
    """a mod q up to one extra q: output in [0, 2q)."""
    return a - mul_hi(a, bred_hi) * q


def mform(a, q, bred_hi, bred_lo):
    """Montgomery form a·2^64 mod q via 128-bit Barrett; a in [0, q)."""
    qhat = a * bred_hi + mul_hi(a, bred_lo)
    r = -(qhat * q)
    return cred(cred(r, q + q), q)


def mform_lazy(a, q, bred_hi, bred_lo):
    """Montgomery form, output in [0, 3q)."""
    qhat = a * bred_hi + mul_hi(a, bred_lo)
    return -(qhat * q)


def imform(a, q, qinv):
    """Leave Montgomery form: a·2^{-64} mod q; a in [0, q)."""
    h = mul_hi(a * qinv, q)
    return cred(q - h, q)


def is_small(q) -> bool:
    """True iff every modulus of the table is < 2^30 (reads the table)."""
    return int(q.max()) < (1 << SMALL_Q_BITS)


def _mred32_lazy(a, b, q, qinv32):
    """a·b·2^{-32} mod q in [0, 2q) for q < 2^30, a·b < q·2^32."""
    ab = a * b
    hi = ab >> 32
    m = ((ab & M32) * qinv32) & M32
    mh = (m * q) >> 32
    return hi - mh + q


def _mred_small_lazy(a, b, q, qinv):
    """a·b·2^{-64} via two cascaded 32-bit Montgomery steps (q < 2^30).

    Requires a < 4q, b < q.
    """
    qinv32 = qinv & M32
    y = _mred32_lazy(a, b, q, qinv32)
    return _mred32_lazy(y, 1, q, qinv32)


def mred(a, b, q, qinv, small: bool | None = None):
    """Montgomery product a·b·2^{-64} mod q, output in [0, q).

    ``small`` states whether every q is < 2^30 (the callers know it from
    their moduli); ``None`` reads the table, which waits for the device.
    """
    if is_small(q) if small is None else small:
        return cred(_mred_small_lazy(a, b, q, qinv), q)
    return mred_wide(a, b, q, qinv)


def mred_lazy(a, b, q, qinv, small: bool | None = None):
    """Montgomery product with lazy output in [0, 2q)."""
    if is_small(q) if small is None else small:
        return _mred_small_lazy(a, b, q, qinv)
    hi = mul_hi(a, b)
    h = mul_hi((a * b) * qinv, q)
    return hi - h + q


def mred_wide(a, b, q, qinv):
    """Montgomery product for a wide left operand (only a·b < q·2^64
    required); always the generic 64-bit path. Output in [0, q)."""
    hi = mul_hi(a, b)
    h = mul_hi((a * b) * qinv, q)
    return cred(hi - h + q, q)


def bred_mul(a, b, q, bred_hi, bred_lo):
    """Full Barrett product a·b mod q for a, b in [0, 2^63)."""
    mhi = mul_hi(a, b)
    mlo = a * b
    qhat = mhi * bred_hi + mul_hi(mhi, bred_lo) + mul_hi(mlo, bred_hi)
    r = mlo - qhat * q
    return cred(cred(r, q + q), q)


# ---------------------------------------------------------------------------
# Elementwise modular vector ops
# ---------------------------------------------------------------------------

def add_mod(a, b, q):
    return cred(a + b, q)


def add_lazy(a, b):
    return a + b


def sub_mod(a, b, q):
    return cred(a - b + q, q)


def neg_mod(a, q):
    return torch.where(a == 0, a, q - a)


def double_mod(a, q):
    return cred(a + a, q)


def mul_mont(a, b, q, qinv, small: bool | None = None):
    """a·b with b in M-form -> normal form, in [0, q)."""
    return mred(a, b, q, qinv, small)


def mul_mont_lazy(a, b, q, qinv, small: bool | None = None):
    return mred_lazy(a, b, q, qinv, small)


def mul_scalar_mont(a, s_mform, q, qinv, small: bool | None = None):
    return mred(a, s_mform, q, qinv, small)


def mred_sum(a, b, q, qinv, bred_hi, margin: int, small: bool | None = None):
    """Σ over axis -4 of the broadcast ``mred_lazy(a, b)``, in [0, q) (a
    gadget MAC: a digits [..., beta, 1, l, N], b key rows [..., beta, 2,
    l, N]). The axis goes in chunks whose product stays under
    :data:`MAC_CHUNK_BYTES`, each reduced to [0, q) and the chunks added
    mod q: the same values as one product over the whole axis (which is
    what a call under the limit runs), with a working set that stays
    bounded at large N and many digits."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    k = shape[-4]
    step = max(1, MAC_CHUNK_BYTES * k // (8 * math.prod(shape)))
    acc = None
    for i in range(0, k, step):
        t = mred_lazy(a[..., i:i + step, :, :, :], b[..., i:i + step, :, :, :],
                      q, qinv, small)
        s = bred_add(lazy_tree_sum(torch.movedim(t, -4, 0), q, bred_hi, margin),
                     q, bred_hi)
        acc = s if acc is None else add_mod(acc, s, q)
    return acc


def lazy_tree_sum(t, q, bred_hi, margin: int):
    """Reduce axis 0 of lazy (< 2q) values with periodic Barrett reduction.

    Sums chunks of up to ``margin`` terms (margin·2q < 2^63, see
    :func:`margin_for`) and lazy-reduces between rounds. Zero padding is
    safe: 0 is a fixed point of the reduction.
    """
    b = t.shape[0]
    while b > 1:
        k = min(max(2, margin), b)
        rem = (-b) % k
        if rem:
            t = torch.cat([t, t.new_zeros((rem,) + tuple(t.shape[1:]))], dim=0)
        t = t.reshape((t.shape[0] // k, k) + tuple(t.shape[1:])).sum(dim=1)
        t = bred_add_lazy(t, q, bred_hi)
        b = t.shape[0]
    return t[0]
