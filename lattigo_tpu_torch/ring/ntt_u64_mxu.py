"""Four-step negacyclic NTT/INTT for primes < 2^61 as exact int8 digit matmuls.

Counterpart of :mod:`lattigo_tpu.ring.ntt_u64_mxu` (``NTTMxu64``), which
the JAX package runs at the XLA level, outside any Pallas kernel, for
every standard ring with N ≥ 4096 and q < 2^61 that its kernels do not
take. The factorization and the raw weight matrices are the four-step
engine's (:func:`.ntt_mxu.gen_four_step_weights`), bit-exact with the
radix-2 engine: with N = R·C and C = max(128, 2^⌊logN/2⌋),

    out[t1, t2] = ( (W1 @ x) . T ) @ W2          (all mod q)

* each operand is split into ``nd_in`` balanced signed base-256 digit
  planes (int8): x + Σ_i 128·256^i read as bytes, each byte less 128;
* each contraction runs against a per-limb int8 weight stack of the
  balanced digits of (2^{8i}·W) mod q, one output plane per weight digit;
  every partial sum stays below 128²·8·max(R, C) ≤ 2^26, so the product is
  exact in int32 and in float64;
* the ``nd_out`` planes recombine into two int64 halves (|lo|, |hi| <
  2^50, each shifted by a multiple of q ≥ 2^50), joined by one WIDE
  Montgomery product with MForm(2^32) whatever the prime's width, and one
  Barrett; the mid-step twiddle is one more Montgomery product.

Digit planes: ``nd_in`` is sized to this engine's input contract, [0, 2q)
(the radix-2 engine's), and ``nd_out`` to weights below q, each the least
count whose balanced range holds the widest prime's bound. The JAX
package's ``(qbits + 3 + 7) // 8`` claims 4q and holds only about 2q at
45, 53 and 61 bits; this engine claims 2q and the tests feed 2q − 1.

The contractions are library matmuls, as the JAX package leaves them to
XLA: one ``torch._int_mm`` (int8 × int8 → int32) per limb, on every
device. A batched float64 ``torch.matmul`` over all limbs gives the same
integers and is kept as ``route="f64"`` to time against it: on one H100
the two took the same time within 2% at the bootstrap ring's 4 × 17 ×
32768 (``chip_smoke.py`` phase 11), and the int8 route moves 8× fewer
weight bytes. Lazy outputs are in [0, 2q), otherwise [0, q).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lattigo_tpu_torch.device import resolve_device
from lattigo_tpu_torch.ring import modops
from lattigo_tpu_torch.ring.ntt_mxu import gen_four_step_weights

MAX_Q_BITS = 61
MIN_N = 4096
#: Coefficients one pass of the engine transforms at most: a larger batch
#: goes in chunks of whole polynomials, which bounds the working memory
#: (digit and product planes, Montgomery temporaries: 291 MiB for the
#: 2^21.1 coefficients of 4 × 17 × 32768, ~140 bytes a coefficient, on one
#: H100 in ``chip_smoke.py`` phase 11) whatever the caller's batch.
CHUNK = 1 << 22

_U64 = np.uint64


def _i64(v: int) -> int:
    """A u64 value as the int64 holding the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def max_balanced(nd: int) -> int:
    """The largest value nd balanced base-256 digits (in [-128, 127]) hold."""
    return 127 * (256 ** nd - 1) // 255


def digit_count(bound: int) -> int:
    """The least digit count, at most 8, whose balanced range holds bound."""
    for nd in range(1, 9):
        if bound <= max_balanced(nd):
            return nd
    raise ValueError(f"{bound} does not fit 8 balanced base-256 digits")


def _bias(nd: int) -> int:
    """Σ_{i<nd} 128·256^i as an int64: added to x, its bytes less 128 are
    x's balanced digits (for 0 ≤ x ≤ max_balanced(nd))."""
    return _i64(sum(128 << (8 * i) for i in range(nd)))


def _shift_mod(a: np.ndarray, k: int, q: int) -> np.ndarray:
    """a·2^k mod q for uint64 a in [0, q), q < 2^61: k modular doublings."""
    a = a.astype(_U64)
    qq = _U64(q)
    for _ in range(k):
        a = a << _U64(1)
        a = np.where(a >= qq, a - qq, a)
    return a


def _balanced_digits(v: np.ndarray, nd: int) -> np.ndarray:
    """uint64 values ≤ max_balanced(nd) → int8 [..., nd] balanced digits."""
    y = v.astype(_U64) + _U64(_bias(nd) % (1 << 64))         # wraps mod 2^64
    b = np.ascontiguousarray(y).view(np.uint8).reshape(v.shape + (8,))
    return (b[..., :nd] ^ 0x80).view(np.int8)


def _extend_weight8(w: np.ndarray, q: int, contract_first: bool,
                    nd_in: int = 8, nd_out: int = 8) -> np.ndarray:
    """[rows, cols] u64 weight matrix -> int8 balanced digits of
    (2^{8i}·w) mod q, the JAX package's layout: [(s, out), (i, in)]
    ([nd_out·r, nd_in·c]) with w = [out, in] if ``contract_first``, else
    [(i, in), (s, out)] ([nd_in·r, nd_out·c]) with w = [in, out]."""
    if q - 1 > max_balanced(nd_out):
        raise ValueError(f"nd_out = {nd_out} too small for q = {q}")
    r, c = w.shape
    ext = [np.asarray(w, dtype=_U64)]
    for _ in range(1, nd_in):
        ext.append(_shift_mod(ext[-1], 8, q))
    out = _balanced_digits(np.stack(ext), nd_out)        # [i, r, c, s]
    if contract_first:
        return np.ascontiguousarray(out.transpose(3, 1, 0, 2)).reshape(
            nd_out * r, nd_in * c)
    return np.ascontiguousarray(out.transpose(0, 1, 3, 2)).reshape(
        nd_in * r, nd_out * c)


def _digits8(x: torch.Tensor, perm: tuple[int, ...], nd: int) -> torch.Tensor:
    """int64 x (0 ≤ x ≤ max_balanced(nd)) -> int8 balanced digit planes:
    x's dims and a last digit axis (least significant first), permuted by
    ``perm`` and cut to ``nd`` planes, contiguous."""
    y = (x + _bias(nd)).view(torch.uint8).view(*x.shape, 8).permute(perm)
    d = y.narrow(perm.index(x.dim()), 0, nd).contiguous()
    return d.bitwise_xor_(0x80).view(torch.int8)


def _recombine8(p: torch.Tensor, k: dict, lazy: bool | None) -> torch.Tensor:
    """Σ_s P_s·2^{8s} mod q from the planes p [l, nd, X]: [l, X], in [0, q)
    ([0, 2q) if lazy) or, with ``lazy=None``, the unreduced t ≡ lo +
    2^32·hi (mod q), 0 ≤ t < 2^52 + 2q. The planes are added one at a time
    into two int64 accumulators, lo = Σ_{s<4} P_s·2^{8s} and hi = Σ_{s≥4}
    P_s·2^{8(s-4)}, so no int64 copy of all planes exists at once."""
    nd = p.shape[1]
    lo = p[:, 0].to(torch.int64)
    hi = p[:, 4].to(torch.int64) if nd > 4 else torch.zeros_like(lo)
    for s in range(1, nd):
        if s != 4:
            (lo if s < 4 else hi).add_(p[:, s], alpha=1 << (8 * (s % 4)))
    # |lo|, |hi| < 2^50; hi + c1 ≈ 2^50 whatever q is: the WIDE Montgomery
    # product; the 32-bit cascade of small moduli assumes a < 4q and would
    # corrupt the limbs of a mixed chain's small primes (a 25-bit residual
    # prime)
    hi.add_(k["c1"])
    t = lo.add_(k["c1"]).add_(modops.mred_wide(hi, k["m32"], k["q"], k["qinv"]))
    if lazy is None:
        return t
    if lazy:
        return modops.bred_add_lazy(t, k["q"], k["bhi"])
    return modops.bred_add(t, k["q"], k["bhi"])


@functools.lru_cache(maxsize=32)
def _prime_tables(n: int, q: int, psi: int, nd_in: int, nd_out: int) -> dict:
    """One prime's host tables (numpy), shared by every ring over (N, q):
    the int8 weight stacks, each [(s, out), (i, in)] so that every
    contraction is W @ digits, and the u64 M-form twiddles TF [R, C] and
    TI transposed [C, R]."""
    logn = n.bit_length() - 1
    cc = max(128, 1 << (logn // 2))
    rr = n // cc
    raw = gen_four_step_weights(n, rr, cc, psi, q)

    def ext(w):
        return _extend_weight8(w, q, True, nd_in=nd_in, nd_out=nd_out)

    def mform(a):
        return np.ascontiguousarray(_shift_mod(a, 64, q))

    return dict(w1f=ext(raw["wa"]), w2f_t=ext(raw["wb"].T),      # [no·R, ni·R], [no·C, ni·C]
                w1i_t=ext(raw["wbi"].T), w2i=ext(raw["wai"]),    # [no·C, ni·C], [no·R, ni·R]
                tf=mform(raw["tf"]), ti_t=mform(raw["ti"].T))


def _contract(w: torch.Tensor, d: torch.Tensor, route: str) -> torch.Tensor:
    """Per-limb product w[j] @ d[j] of int8 [l, M, K] and [l, K, N] as
    int32: one ``torch._int_mm`` a limb (route "int8") or one batched
    float64 matmul (route "f64"); exact either way."""
    if route == "f64":
        return torch.matmul(w.to(torch.float64), d.to(torch.float64)).to(torch.int32)
    if route != "int8":
        raise ValueError(f"unknown contraction route {route!r}")
    out = torch.empty((w.shape[0], w.shape[1], d.shape[2]), dtype=torch.int32,
                      device=d.device)
    for wj, dj, oj in zip(w.unbind(0), d.unbind(0), out.unbind(0)):
        torch._int_mm(wj, dj, out=oj)
    return out


def _u64(vals, device) -> torch.Tensor:
    """Host ints in [0, 2^64) -> int64 [L, 1] (same bits) on device."""
    return torch.tensor([[_i64(int(v))] for v in vals], dtype=torch.int64,
                        device=device)


class NTTMxu64:
    """Per-ring four-step NTT/INTT tables for q < 2^61 and its entry points.

    Tables on ``device``: the int8 weight stacks ``w1f``, ``w2i`` [L, no·R,
    ni·R] and ``w2f_t``, ``w1i_t`` [L, no·C, ni·C] (W2f and W1i
    transposed); the twiddles ``tf`` [L, R, C] and ``ti_t`` [L, C, R]
    int64 (u64 M-form bit patterns); per limb (``consts``, int64 [L, 1])
    q, q^{-1} mod 2^64, MForm(2^32), the recombination shift c1 (a multiple
    of q ≥ 2^50) and the Barrett word.
    """

    def __init__(self, n: int, moduli: list[int], psis: list[int], device=None):
        if not all(q < (1 << MAX_Q_BITS) for q in moduli):
            raise ValueError("the u64 four-step NTT needs every q < 2^61")
        if not (n >= MIN_N and n & (n - 1) == 0):
            raise ValueError(f"the u64 four-step NTT needs N ≥ {MIN_N}, a power of two")
        self.device = resolve_device(device)
        self.n = n
        self.logn = n.bit_length() - 1
        self.cc = max(128, 1 << (self.logn // 2))
        self.rr = n // self.cc
        qmax = max(moduli)
        self.nd_in = digit_count(2 * qmax - 1)     # operands in [0, 2q)
        self.nd_out = digit_count(qmax - 1)        # reduced weights < q
        tabs = [_prime_tables(n, q, psi, self.nd_in, self.nd_out)
                for q, psi in zip(moduli, psis)]
        dev = self.device

        def stack(key, dtype=np.int8):
            return torch.from_numpy(np.stack([t[key] for t in tabs]).view(dtype)).to(dev)

        self.w1f, self.w2f_t = stack("w1f"), stack("w2f_t")
        self.w1i_t, self.w2i = stack("w1i_t"), stack("w2i")
        self.tf, self.ti_t = stack("tf", np.int64), stack("ti_t", np.int64)
        self.consts = dict(
            q=_u64(moduli, dev),
            qinv=_u64([pow(q, -1, 1 << 64) for q in moduli], dev),
            m32=_u64([(1 << 96) % q for q in moduli], dev),          # MForm(2^32)
            c1=_u64([((1 << 50) // q + 1) * q for q in moduli], dev),
            bhi=_u64([modops.gen_bred_constant(q)[0] for q in moduli], dev))

    def table_bytes(self) -> int:
        """Device bytes of the engine's tables."""
        ts = (self.w1f, self.w2f_t, self.w1i_t, self.w2i, self.tf, self.ti_t,
              *self.consts.values())
        return sum(t.numel() * t.element_size() for t in ts)

    def _apply(self, x, s: slice, inverse: bool, lazy: bool, route: str = "int8"):
        """The transform of x int64[..., l, N] over the limbs ``s`` of the
        tables, its contractions by ``route`` (:func:`_contract`); a batch
        of more than :data:`CHUNK` coefficients goes in chunks of whole
        polynomials."""
        if x.dtype != torch.int64 or x.dim() < 2 or x.shape[-1] != self.n:
            raise ValueError(f"expected int64[..., limbs, {self.n}], got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != self.device:
            raise ValueError(f"tensor on {x.device}, tables on {self.device}")
        l = x.shape[-2]
        x4 = x.reshape(-1, l, self.rr, self.cc)             # [b, l, R, C]
        k = {name: v[s] for name, v in self.consts.items()}
        step = max(1, CHUNK // (l * self.n))
        if x4.shape[0] <= step:
            return self._transform(x4, s, k, inverse, lazy, route).reshape(x.shape)
        out = torch.empty_like(x4)
        for i in range(0, x4.shape[0], step):
            out[i:i + step] = self._transform(x4[i:i + step], s, k, inverse, lazy, route)
        return out.view(x.shape)

    def _transform(self, x4, s: slice, k: dict, inverse: bool, lazy: bool,
                   route: str):
        """x4 int64 [b, l, R, C] -> its transform, a [b, l, R, C] view."""
        b, l = x4.shape[:2]
        rr, cc, ni, no = self.rr, self.cc, self.nd_in, self.nd_out
        q4, qinv4 = (k[n].view(-1, 1, 1, 1) for n in ("q", "qinv"))
        if inverse:
            # contract C: W1i^T [(s, C), (i, C)] @ digits [(i, C), (R, b)]
            p = _contract(self.w1i_t[s], _digits8(x4, (1, 4, 3, 2, 0), ni).view(
                l, ni * cc, rr * b), route).view(l, no, -1)
            h = modops.mred_wide(_recombine8(p, k, None).view(l, cc, rr, b),
                                 self.ti_t[s][..., None], q4, qinv4)
            # contract R: W2i [(s, R), (i, R)] @ digits [(i, R), (b, C)]
            p = _contract(self.w2i[s], _digits8(h, (0, 4, 2, 3, 1), ni).view(
                l, ni * rr, b * cc), route).view(l, no, -1)
            del h
            return _recombine8(p, k, lazy).view(l, rr, b, cc).permute(2, 0, 1, 3)
        # contract R: W1f [(s, R), (i, R)] @ digits [(i, R), (b, C)]
        p = _contract(self.w1f[s], _digits8(x4, (1, 4, 2, 0, 3), ni).view(
            l, ni * rr, b * cc), route).view(l, no, -1)
        h = modops.mred_wide(_recombine8(p, k, None).view(l, rr, b, cc),
                             self.tf[s][:, :, None, :], q4, qinv4)
        # contract C: W2f^T [(s, C), (i, C)] @ digits [(i, C), (R, b)]
        p = _contract(self.w2f_t[s], _digits8(h, (0, 4, 3, 1, 2), ni).view(
            l, ni * cc, rr * b), route).view(l, no, -1)
        del h
        return _recombine8(p, k, lazy).view(l, cc, rr, b).permute(3, 0, 2, 1)

    def ntt(self, x, lazy: bool = False):
        return self._apply(x, slice(0, x.shape[-2]), False, lazy)

    def intt(self, x, lazy: bool = False):
        return self._apply(x, slice(0, x.shape[-2]), True, lazy)

    def ntt_single(self, i: int, x, lazy: bool = False):
        return self._apply(x, slice(i, i + 1), False, lazy)

    def intt_single(self, i: int, x, lazy: bool = False):
        return self._apply(x, slice(i, i + 1), True, lazy)
