"""Plain NumPy residue-number-system arithmetic for the reference.

Independent of the program: the primitive roots are searched here, the
negacyclic transform is an evaluation at the odd powers of a primitive
2N-th root in bit-reversed order (the order of Lattigo's rings), and every
product is exact: in uint64 below 2^32, and above it by a quotient taken
in extended precision (or, where ``np.longdouble`` has no 64-bit
mantissa, in chunks).
"""

from __future__ import annotations

import functools

import numpy as np

#: np.longdouble holds a 64-bit mantissa (x86's extended precision)
_EXTENDED = np.finfo(np.longdouble).nmant >= 63


def _prime_factors(n: int) -> list[int]:
    out, d = [], 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        out.append(n)
    return out


@functools.lru_cache(maxsize=None)
def psi(q: int, n: int) -> int:
    """The primitive 2n-th root of unity mod q taken from the smallest
    generator of (Z/qZ)^*: g^((q-1)/2n)."""
    if (q - 1) % (2 * n):
        raise ValueError(f"{q} is not 1 mod {2 * n}")
    factors = _prime_factors(q - 1)
    g = 2
    while any(pow(g, (q - 1) // f, q) == 1 for f in factors):
        g += 1
    return pow(g, (q - 1) // (2 * n), q)


def bit_reverse(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def mulmod(a: np.ndarray, b: np.ndarray, q: np.ndarray) -> np.ndarray:
    """a·b mod q, elementwise in uint64, for a, b in [0, q); q broadcasts
    as a column [L, 1]. Rows whose prime is 2^32 or more multiply b in
    chunks small enough that no partial sum passes 2^64, or, where
    ``np.longdouble`` has a 64-bit mantissa, as a·b − ⌊a·b·(1/q)⌋·q mod 2^64
    with the quotient taken in it: off by at most one for q < 2^62, which
    one correction step mends."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    q = np.asarray(q, dtype=np.uint64)
    qmax = int(q.max())
    if qmax < (1 << 32):
        return (a * b) % q
    if _EXTENDED and qmax < (1 << 62):
        ld = np.longdouble
        quot = (a.astype(ld) * b.astype(ld) * (ld(1) / q.astype(ld))).astype(np.uint64)
        r = (a * b - quot * q).view(np.int64)          # exact: in (-q, 2q)
        qs = q.view(np.int64)
        r = np.where(r < 0, r + qs, r)
        return np.where(r >= qs, r - qs, r).view(np.uint64)
    c = 63 - qmax.bit_length()            # chunk bits: acc·2^c + a·chunk < 2^64
    if c < 1:
        raise ValueError("primes of 63 bits or more are not supported")
    a, b = np.broadcast_arrays(a, b)
    acc = np.zeros(a.shape, dtype=np.uint64)
    mask = np.uint64((1 << c) - 1)
    for shift in range(((qmax.bit_length() + c - 1) // c) * c - c, -1, -c):
        chunk = (b >> np.uint64(shift)) & mask
        acc = ((acc << np.uint64(c)) % q + (a * chunk) % q) % q
    return acc


def _powers(w: np.ndarray, count: int, q: np.ndarray) -> np.ndarray:
    """[L, count] table of w^j mod q (w, q columns [L, 1])."""
    out = np.ones((w.shape[0], count), dtype=np.uint64)
    if count > 1:
        out[:, 1:2] = w
    filled, step = 2, mulmod(w, w, q)
    while filled < count:
        take = min(filled, count - filled)
        out[:, filled:filled + take] = mulmod(out[:, :take], step, q)
        step = mulmod(step, step, q)
        filled += take
    return out


def _cyclic(x: np.ndarray, w: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Y[t] = Σ_i x[i]·w^(i·t) mod q over rows [L, N] (radix 2, decimation
    in time)."""
    n = x.shape[-1]
    x = x[:, bit_reverse(n)]
    tw = _powers(w, n // 2, q)
    m = 1
    while m < n:
        stride = n // (2 * m)
        t = tw[:, ::stride][:, :m][:, None, :]
        v = x.reshape(x.shape[0], n // (2 * m), 2, m)
        u, odd = v[:, :, 0, :], mulmod(v[:, :, 1, :], t, q[:, :, None])
        qe = q[:, :, None]
        x = np.stack([(u + odd) % qe, (u + qe - odd) % qe], axis=2).reshape(x.shape)
        m *= 2
    return x


def _cols(moduli) -> np.ndarray:
    return np.asarray(moduli, dtype=np.uint64)[:, None]


def ntt(a: np.ndarray, moduli: list[int]) -> np.ndarray:
    """a[L, N] (coefficients, row i mod moduli[i]) → its values at
    ψ^(2·brev(k)+1) in slot k, the order of Lattigo's rings."""
    n = a.shape[-1]
    q = _cols(moduli)
    ps = np.array([psi(m, n) for m in moduli], dtype=np.uint64)[:, None]
    tw = _powers(ps, n, q)
    y = _cyclic(mulmod(a % q, tw, q), mulmod(ps, ps, q), q)
    return y[:, bit_reverse(n)]


def intt(x: np.ndarray, moduli: list[int]) -> np.ndarray:
    """Inverse of :func:`ntt`."""
    n = x.shape[-1]
    q = _cols(moduli)
    ips = np.array([pow(psi(m, n), -1, m) for m in moduli], dtype=np.uint64)[:, None]
    y = _cyclic(x[:, bit_reverse(n)], mulmod(ips, ips, q), q)
    ninv = np.array([pow(n, -1, m) for m in moduli], dtype=np.uint64)[:, None]
    return mulmod(mulmod(y, _powers(ips, n, q), q), ninv, q)


def lift_small(x: np.ndarray, moduli: list[int]) -> np.ndarray:
    """Signed small integers x[N] → residues [L, N]."""
    x = np.asarray(x, dtype=np.int64)
    return np.stack([np.mod(x, m) for m in moduli]).astype(np.uint64)


def crt_centred(r: np.ndarray, moduli: list[int]) -> np.ndarray:
    """The centred integers (Python ints, object array [N]) whose residues
    mod each of ``moduli`` are the rows of r[L, N]."""
    m = r[0].astype(object)
    done = moduli[0]
    for i in range(1, len(moduli)):
        qi = moduli[i]
        t = ((r[i].astype(object) - m) % qi) * pow(done, -1, qi) % qi
        m = m + done * t
        done *= qi
    return np.where(m > done // 2, m - done, m)


def crt_small(r: np.ndarray, moduli: list[int], bits: int) -> tuple[np.ndarray, int]:
    """The centred integer m[N] (as float64) that the first rows of r[L, N]
    determine, taking rows until their product passes 2^(bits+1), and the
    number of residues of every row that disagree with it. A correct
    decryption of a value below 2^bits disagrees nowhere."""
    k, prod = 0, 1
    while k < len(moduli) and prod <= (1 << (bits + 1)):
        prod *= moduli[k]
        k += 1
    if prod <= (1 << (bits + 1)):
        raise ValueError(f"the chain cannot hold a {bits}-bit value")
    m = crt_centred(r[:k], moduli[:k])
    if max(abs(int(m.max())), abs(int(m.min()))) < 1 << 62:
        m_rows = m.astype(np.int64)
    else:
        m_rows = m
    bad = sum(int(np.count_nonzero(np.mod(m_rows, qi).astype(np.uint64) != r[i]))
              for i, qi in enumerate(moduli))
    return m.astype(np.float64), bad
