"""Four-step negacyclic NTT/INTT as exact int8 digit matmuls.

Counterpart of :mod:`lattigo_tpu.ring.ntt_mxu` (the TPU's MXU kernel).
With N = R·C and C = max(128, 2^⌊logN/2⌋):

    out[t1, t2] = ( (W1 @ digits(x)) . T ) @ W2          (all mod q)

with the bit-reversal of the NTT layout and the negacyclic ψ-twist folded
into host-precomputed matrices, so the result is bit-exact with the
radix-2 engine (same output permutation). Operands are split into four
balanced signed base-256 digit planes; each weight digit matrix encodes
digit_s((2^{8i}·W) mod q), stacked so one [4A, 4A] product yields all four
output planes, |P_s| ≤ 128·128·4A ≤ 2^23. The planes are recombined mod q
with one 32-bit Montgomery multiply (split at 2^24) and the mid-step
twiddle is one more.

Two implementations of the same function live here:

* :func:`four_step_plain`: plain torch. Its contractions are float64
  matmuls, exact because every partial sum stays below 2^24, so it runs on
  the CPU and on CUDA alike;
* the CUDA kernel ``csrc/ntt_mxu.cu``, launched by :func:`four_step_cuda`,
  one launch a call. Its products run on int8 tensor cores. Up to
  N = 2^14 (:data:`FUSED_MAX_N`) it reads the weight digits in the order
  of its ``mma`` A fragments (:func:`mma_fragment_order`) and splits each
  (limb, polynomial) over S blocks that never exchange data; at N = 2^15
  and 2^16 a thread-block cluster of S blocks takes one limb and
  S·2^14/N polynomials of it, reads the weights as 16 KB ``wgmma`` tiles
  (:func:`wgmma_tile_order`) multicast to the cluster, and passes step
  1's digits between its blocks in shared memory (:meth:`NTTMxu.split_for`
  picks S).

:class:`NTTMxu` sends a CPU tensor to the plain version and a CUDA tensor
to the kernel; there is no fallback between them. Requires q < 2^29 and
4096 ≤ N ≤ 65536 (the kernel's templates). Lazy outputs are in [0, 2q),
otherwise [0, q).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from lattigo_tpu_torch import build
from lattigo_tpu_torch.device import resolve_device
from lattigo_tpu_torch.ring.ntt import bit_reverse
from lattigo_tpu_torch.ring.ntt_pallas import mred_lazy32 as _mred_lazy32

MAX_Q_BITS = 29
MIN_N = 4096
MAX_N = 1 << 16
#: Largest N whose call runs on independent blocks; above it, on clusters.
FUSED_MAX_N = 1 << 14
M8 = 0xFF
M16 = 0xFFFF
M32 = 0xFFFFFFFF
#: Splits of one (limb, polynomial) over blocks that the kernel has up to
#: FUSED_MAX_N; above it, its cluster sizes (those of at least N / 2^14
#: blocks: a block holds 64 KB of digits a step).
SPLITS = (1, 2, 4, 8)
CLUSTER_SIZES = (2, 4, 8)
#: Shared memory an H100 SM gives its blocks, and what it keeps per block.
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED_PER_BLOCK = 1024
#: A weight tile of the cluster kernel, and its block's shared memory: two
#: 64 KB digit slabs, a ring of 6 tiles and its 12 mbarriers.
TILE_BYTES = 16384
CLUSTER_SMEM = 2 * 65536 + 6 * TILE_BYTES + 12 * 8

#: Launch counts of the CUDA kernel, by direction. Each launch (one a
#: call) adds one; the plain version adds nothing.
LAUNCHES = {"forward": 0, "inverse": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Host-side table generation
# ---------------------------------------------------------------------------

def _mform32(a: int, q: int) -> int:
    return (a << 32) % q


def _pow_table(base: int, count: int, q: int) -> np.ndarray:
    out = np.empty(count, dtype=np.uint64)
    p = 1
    for i in range(count):
        out[i] = p
        p = p * base % q
    return out


def _signed_digits(vals: np.ndarray, ndig: int = 4) -> list[np.ndarray]:
    """Balanced base-256 digits (each in [-128, 127]) of values < 2^31."""
    v = vals.astype(np.int64)
    digs = []
    for _ in range(ndig):
        d = v & 255
        carry = d >= 128
        d = d - (carry << 8)
        v = (v >> 8) + carry
        digs.append(d)
    assert np.all(v == 0), "value too large for balanced digit count"
    return digs


def _extend_weight(w: np.ndarray, q: int, contract_first: bool) -> np.ndarray:
    """[rows, cols] weight matrix -> [4*rows, 4*cols] int8 balanced digits
    of (2^{8i} * w) mod q.

    contract_first=True  -> layout [(s, out), (i, in)] with w = [out, in]
    contract_first=False -> layout [(i, in), (s, out)] with w = [in, out]
    """
    r, c = w.shape
    ext = np.empty((4, r, c), dtype=np.uint64)
    for i in range(4):
        ext[i] = (w * np.uint64((1 << (8 * i)) % q)) % np.uint64(q)
    digs = _signed_digits(ext.reshape(-1))
    out = np.empty((4, 4, r, c), dtype=np.int8)   # [s, i, r, c]
    for s in range(4):
        out[s] = digs[s].reshape(4, r, c).astype(np.int8)
    if contract_first:
        return out.transpose(0, 2, 1, 3).reshape(4 * r, 4 * c)
    return out.transpose(1, 2, 0, 3).reshape(4 * r, 4 * c)


def gen_four_step_weights(n: int, rr: int, cc: int, psi: int, q: int):
    """Raw weight matrices of the four-step factorization (uint64).

    Forward:  out = ( (WA @ M) . * TF ) @ WB              (all mod q)
      WA[t1, j1] = w^{C j1 brev(t1)} psi^{C j1}
      TF[t1, j2] = w^{j2 brev(t1)} * psi^{j2}
      WB[j2, t2] = w^{R j2 brev(t2)}
    Inverse (bit-reversed input, N^{-1} folded into WAI):
      WBI[t2, j2] = w^{-R j2 brev(t2)}
      TI[t1, j2]  = w^{-j2 brev(t1)} * psi^{-j2}
      WAI[j1, t1] = w^{-C j1 brev(t1)} psi^{-C j1}/N

    A product of two residues is taken in uint64 where q < 2^32 (it stays
    below 2^64), in Python integers otherwise (the u64 engine's primes)."""
    logr = rr.bit_length() - 1
    logc = cc.bit_length() - 1
    w = psi * psi % q
    wi = pow(w, -1, q)
    psii = pow(psi, -1, q)
    ninv = pow(n, -1, q)

    def mul(a, b):
        if q < (1 << 32):
            return a * b % np.uint64(q)
        prod = np.asarray(a).astype(object) * np.asarray(b).astype(object)
        return (prod % q).astype(np.uint64)

    brev_r = np.array([bit_reverse(t, logr) for t in range(rr)])
    brev_c = np.array([bit_reverse(t, logc) for t in range(cc)])

    u = _pow_table(pow(w, cc, q), rr, q)
    psic = _pow_table(pow(psi, cc, q), rr, q)
    wa = mul(u[np.outer(brev_r, np.arange(rr)) % rr], psic[None, :])
    wp = _pow_table(w, n, q)
    psip = _pow_table(psi, cc, q)
    tf = mul(wp[np.outer(brev_r, np.arange(cc)) % n], psip[None, :cc])
    v = _pow_table(pow(w, rr, q), cc, q)
    wb = v[np.outer(np.arange(cc), brev_c) % cc]

    ui = _pow_table(pow(wi, rr, q), cc, q)
    wbi = ui[np.outer(brev_c, np.arange(cc)) % cc]
    wpi = _pow_table(wi, n, q)
    psiip = _pow_table(psii, cc, q)
    ti = mul(wpi[np.outer(brev_r, np.arange(cc)) % n], psiip[None, :cc])
    uii = _pow_table(pow(wi, cc, q), rr, q)
    psici = _pow_table(pow(psii, cc, q), rr, q)
    wai = mul(mul(uii[np.outer(np.arange(rr), brev_r) % rr], psici[:, None]),
              np.uint64(ninv))
    return dict(wa=wa, tf=tf, wb=wb, wbi=wbi, ti=ti, wai=wai)


def gen_mxu_tables(n: int, rr: int, cc: int, psi: int, q: int):
    """Per-prime constant pack: int8 digit extensions of the raw weights
    (same layouts as the TPU kernel's) + Montgomery-form (2^32) twiddles."""
    raw = gen_four_step_weights(n, rr, cc, psi, q)

    def mont(a):                       # a * 2^32 mod q, exact: a < 2^29
        return ((a << np.uint64(32)) % np.uint64(q)).astype(np.uint32)

    return dict(
        w1f=_extend_weight(raw["wa"], q, contract_first=True),     # [4R, 4R]
        tf=mont(raw["tf"]),                                        # [R, C]
        w2f=_extend_weight(raw["wb"], q, contract_first=False),    # [4C, 4C]
        w1i=_extend_weight(raw["wbi"], q, contract_first=False),   # [4C, 4C]
        ti=mont(raw["ti"]),                                        # [R, C]
        w2i=_extend_weight(raw["wai"], q, contract_first=True),    # [4R, 4R]
    )


def gen_consts(moduli: list[int]) -> np.ndarray:
    """uint32 [L, 8]: q, q^{-1} mod 2^32, MForm32(2^24), the bias
    correction -(2^24·(1 + 2^8 + 2^16 + 2^24)) mod q, MForm32(1)."""
    consts = np.zeros((len(moduli), 8), dtype=np.uint32)
    for i, q in enumerate(moduli):
        consts[i, 0] = q
        consts[i, 1] = pow(q, -1, 1 << 32)
        consts[i, 2] = _mform32((1 << 24) % q, q)
        b = ((1 << 24) * (1 + (1 << 8) + (1 << 16) + (1 << 24))) % q
        consts[i, 3] = (q - b) % q
        consts[i, 4] = _mform32(1, q)
    return consts


def mma_fragment_order(w: np.ndarray) -> np.ndarray:
    """int8 [..., M, K] -> [..., M·K] in the order the kernel loads its
    ``mma.m16n8k32`` A fragments: [M/16 tiles][K/32 k steps][32 lanes][16
    bytes], lane 4g + t holding rows g and g + 8 of the tile at k 4t..4t+3
    (bytes 0-3 and 4-7) and at k 16+4t..19+4t (bytes 8-11 and 12-15)."""
    *lead, m, k = w.shape
    v = w.reshape(*lead, m // 16, 2, 8, k // 32, 2, 4, 4)
    n = len(lead)                 # tile, h, g, step, half, t, byte
    perm = [*range(n), *(n + i for i in (0, 3, 2, 5, 4, 1, 6))]
    return np.ascontiguousarray(v.transpose(perm)).reshape(*lead, m * k)


def wgmma_tile_order(w: np.ndarray) -> np.ndarray:
    """int8 [..., 4A, 4A] (A = 128 or 256) -> [..., 16 A²] in the order the
    cluster kernel copies its weight tiles: [8 jobs][4A/KC tiles] of
    :data:`TILE_BYTES` each, KC = 2·TILE_BYTES / A bytes of K. Job j holds
    the rows s·A + j·A/8 + a (plane s, a < A/8) as tile rows n = s·A/8 + a,
    in wgmma's K-major layout without swizzle: [n / 8][KC / 16 core
    columns][n % 8][16 bytes]."""
    *lead, m, k = w.shape
    a = m // 4
    aj, kc = a // 8, 2 * TILE_BYTES // a
    v = w.reshape(*lead, 4, 8, aj // 8, 8, k // kc, kc // 16, 16)
    n = len(lead)                 # s, job, n8, row, tile, core, byte
    perm = [*range(n), *(n + i for i in (1, 4, 0, 2, 5, 3, 6))]
    return np.ascontiguousarray(v.transpose(perm)).reshape(*lead, m * k)


def kernel_smem(rr: int, cc: int, split: int, inverse: bool) -> int:
    """Shared-memory bytes of one block of ``csrc/ntt_mxu.cu``. Up to
    :data:`FUSED_MAX_N` (its ``Layout``, rows padded to 16 mod 128 bytes):
    the input's digit planes and 1/split of step 1's. Above: the cluster
    kernel's :data:`CLUSTER_SMEM` at every cluster size."""
    ldr, ldc = 4 * rr + 16, 4 * cc + 16
    if rr * cc > FUSED_MAX_N:
        return CLUSTER_SMEM
    if inverse:
        return rr * ldc + cc // split * ldr
    return cc * ldr + rr // split * ldc


def pick_split(rows: int, sms: int, least: int, most: int) -> int:
    """The least S in :data:`SPLITS` from ``least`` to ``most`` with
    rows·S ≥ sms."""
    s = least
    while s < most and rows * s < sms:
        s *= 2
    return s


# ---------------------------------------------------------------------------
# Plain torch version
# ---------------------------------------------------------------------------

def _digit_planes(x):
    """int64 (< 2^30) -> 4 balanced signed base-256 digit planes, float64."""
    planes = []
    v = x
    for _ in range(4):
        d = v & M8
        c = d >> 7
        v = (v >> 8) + c
        planes.append((d - (c << 8)).to(torch.float64))
    return planes


def _recombine(p, dim: int, k):
    """sum_s P_s 2^{8s} mod q from the 4 planes stacked along ``dim``;
    out < 2^32, congruent mod q."""
    q, qinv, c24m, negb, _ = k
    u0, u1, u2, u3 = (t.to(torch.int64) + (1 << 24)
                      for t in p.chunk(4, dim=dim))
    lo = u0 + ((u1 & M16) << 8) + ((u2 & M8) << 16)
    hi = (u1 >> 16) + (u2 >> 8) + u3
    return (lo + _mred_lazy32(hi, c24m, q, qinv) + negb) & M32


def four_step_plain(eng: "NTTMxu", x, limb_lo: int, inverse: bool,
                    lazy: bool):
    """The kernel's function in plain torch: x int64[..., l, N] -> same."""
    shape = x.shape
    l = shape[-2]
    rr, cc = eng.rr, eng.cc
    sl = slice(limb_lo, limb_lo + l)
    c = eng.consts[sl].to(torch.int64) & M32                      # [l, 8]
    k = tuple(c[:, i].reshape(l, 1, 1) for i in range(5))
    q, qinv, _, _, onem = k
    x = _mred_lazy32(x.reshape(-1, l, rr, cc) & M32, onem, q, qinv)
    if inverse:
        w1 = eng.w1i_t[sl].transpose(-1, -2).to(torch.float64)    # W1i
        pm = torch.matmul(torch.cat(_digit_planes(x), dim=-1), w1)
        h = _mred_lazy32(_recombine(pm, -1, k),
                         eng.ti_t[sl].transpose(-1, -2).to(torch.int64),
                         q, qinv)
        w2 = eng.w2i[sl].to(torch.float64)
        pm2 = torch.matmul(w2, torch.cat(_digit_planes(h), dim=-2))
        v = _recombine(pm2, -2, k)
    else:
        w1 = eng.w1f[sl].to(torch.float64)
        pm = torch.matmul(w1, torch.cat(_digit_planes(x), dim=-2))
        b = _mred_lazy32(_recombine(pm, -2, k), eng.tf[sl].to(torch.int64),
                         q, qinv)
        w2 = eng.w2f_t[sl].transpose(-1, -2).to(torch.float64)    # W2f
        pm2 = torch.matmul(torch.cat(_digit_planes(b), dim=-1), w2)
        v = _recombine(pm2, -1, k)
    v = _mred_lazy32(v, onem, q, qinv)
    if not lazy:
        v = torch.where(v >= q, v - q, v)
    return v.reshape(shape)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_ptr = ctypes.c_void_p
_int = ctypes.c_int


class _Engine(ctypes.Structure):
    """``NttMxuEngine`` of ``csrc/ntt_mxu.cu``."""
    _fields_ = [("consts", _ptr), ("w1f", _ptr), ("tf", _ptr), ("w2f", _ptr),
                ("w1i", _ptr), ("ti", _ptr), ("w2i", _ptr), ("logn", _int),
                ("device", _int)]


class _Binding:
    """What a launch needs beyond its tensors, resolved once per engine:
    the C function and the engine's tables, logN and device as one C
    struct (``ptr`` is its address; the engine keeps the tables alive)."""

    def __init__(self, eng: "NTTMxu"):
        fn = build.load("ntt_mxu").ntt_mxu_launch
        fn.argtypes = [_ptr] * 3 + [_int] * 5 + [_ptr]
        fn.restype = _int
        self.fn = fn
        self.device = eng.device.index
        w1f, w2f, w1i, w2i = eng.kernel_tables
        self.engine = _Engine(
            eng.consts.data_ptr(), w1f.data_ptr(), eng.tf.data_ptr(),
            w2f.data_ptr(), w1i.data_ptr(), eng.ti_t.data_ptr(),
            w2i.data_ptr(), eng.logn, self.device)
        self.ptr = ctypes.addressof(self.engine)


def four_step_cuda(eng: "NTTMxu", x, limb_lo: int, inverse: bool,
                   lazy: bool, split: int | None = None):
    """Launch ``csrc/ntt_mxu.cu`` on x int64[..., l, N] (CUDA, contiguous).
    ``split`` forces the number of blocks per (limb, polynomial), or above
    :data:`FUSED_MAX_N` the cluster size, for tests and measurements; by
    default :meth:`NTTMxu.split_for` picks it. The kernel makes
    ``x.device`` current for its launch when it is not, on that device's
    current stream."""
    if x.dtype != torch.int64:
        raise TypeError(f"ntt_mxu kernel takes int64 residues, got {x.dtype}")
    if x.device != eng.device:
        raise ValueError(f"tensor on {x.device}, tables on {eng.device}")
    if x.dim() < 2 or x.shape[-1] != eng.n:
        raise ValueError(f"expected [..., limbs, {eng.n}], got {tuple(x.shape)}")
    l = x.shape[-2]
    if limb_lo < 0 or limb_lo + l > eng.consts.shape[0]:
        raise ValueError(f"limbs [{limb_lo}, {limb_lo + l}) outside the "
                         f"{eng.consts.shape[0]}-limb table")
    if not x.is_contiguous():
        raise ValueError("ntt_mxu kernel needs a contiguous tensor")
    rows = x.numel() // eng.n
    if split is None:
        split = eng.split_for(rows, inverse)
    elif split not in eng.splits or split > eng.max_split(inverse):
        raise ValueError(f"split {split} not in {eng.splits} up to "
                         f"{eng.max_split(inverse)}")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    k = eng._binding
    err = k.fn(x.data_ptr(), out.data_ptr(), k.ptr, inverse | lazy << 1, rows,
               l, limb_lo, split, torch.cuda.current_stream(k.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ntt_mxu kernel launch failed: CUDA error {err}")
    LAUNCHES["inverse" if inverse else "forward"] += 1
    return out


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def _i8(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int8))


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


class NTTMxu:
    """Per-ring four-step NTT/INTT tables and entry points.

    Tables on ``device``: consts int32 [L, 8] (u32 bit patterns), the
    weight digits int8 — ``w1f`` [L, 4R, 4R], ``w2f_t`` [L, 4C, 4C] (W2f
    transposed so every output's contraction is contiguous), ``w1i_t``
    [L, 4C, 4C] (W1i transposed), ``w2i`` [L, 4R, 4R] — and the twiddles
    int32 ``tf`` [L, R, C] and ``ti_t`` [L, C, R] (TI transposed). The
    kernel reads the four weight tables, those of ``w1f``, ``w2f_t``,
    ``w1i_t`` and ``w2i``, in its own order (``kernel_tables``, int8
    [L, 16 A²]): up to :data:`FUSED_MAX_N` in :func:`mma_fragment_order`,
    above it in :func:`wgmma_tile_order`.
    """

    def __init__(self, n: int, moduli: list[int], psis: list[int], device):
        if not all(q < (1 << MAX_Q_BITS) for q in moduli):
            raise ValueError("four-step NTT needs every q < 2^29")
        if not (MIN_N <= n <= MAX_N and n & (n - 1) == 0):
            raise ValueError(f"four-step NTT needs N in [{MIN_N}, {MAX_N}]")
        self.device = resolve_device(device)
        self.n = n
        self.logn = n.bit_length() - 1
        self.cc = max(128, 1 << (self.logn // 2))
        self.rr = n // self.cc
        #: kernel launches a call, and the splits (cluster sizes above
        #: FUSED_MAX_N) the kernel has for this N
        self.launches_per_call = 1
        self.splits = (SPLITS if n <= FUSED_MAX_N
                       else tuple(s for s in CLUSTER_SIZES if s * (1 << 14) >= n))
        packs = [gen_mxu_tables(n, self.rr, self.cc, psi, q)
                 for psi, q in zip(psis, moduli)]

        def stack(key, transpose=False):
            a = np.stack([p[key] for p in packs])
            return a.transpose(0, 2, 1) if transpose else a

        def dev(a, conv=_i8):
            return conv(a).to(self.device)

        self.consts = _i32(gen_consts(moduli)).to(self.device)
        weights = {"w1f": stack("w1f"), "w2f_t": stack("w2f", True),
                   "w1i_t": stack("w1i", True), "w2i": stack("w2i")}
        self.w1f, self.w2f_t = dev(weights["w1f"]), dev(weights["w2f_t"])
        self.w1i_t, self.w2i = dev(weights["w1i_t"]), dev(weights["w2i"])
        order = mma_fragment_order if n <= FUSED_MAX_N else wgmma_tile_order
        self.kernel_tables = tuple(dev(order(weights[key]))
                                   for key in ("w1f", "w2f_t", "w1i_t", "w2i"))
        self.tf = dev(stack("tf"), _i32)
        self.ti_t = dev(stack("ti", True), _i32)
        self._split_range = {inv: (self.min_split(inv), self.max_split(inv))
                             for inv in (False, True)}

    def max_split(self, inverse: bool) -> int:
        """Most blocks per (limb, polynomial): each needs a 16-row slab of
        the split dimension (t1 of R forward, j2 of C inverse); above
        FUSED_MAX_N, the largest cluster (every slab of a polynomial is
        16 columns or more at 8)."""
        return min(self.splits[-1], (self.cc if inverse else self.rr) // 16)

    def min_split(self, inverse: bool) -> int:
        """Least blocks per (limb, polynomial) at which two blocks share an
        SM (one block of the unsplit layout fills it alone at logN 14);
        above FUSED_MAX_N, the least cluster (one block an SM)."""
        if self.n > FUSED_MAX_N:
            return self.splits[0]
        for s in self.splits:
            if 2 * (kernel_smem(self.rr, self.cc, s, inverse)
                    + SMEM_RESERVED_PER_BLOCK) <= SMEM_PER_SM:
                return s
        return self.splits[-1]

    @functools.cached_property
    def _binding(self) -> _Binding:
        return _Binding(self)

    @functools.cached_property
    def _sm_count(self) -> int:
        return torch.cuda.get_device_properties(self.device).multi_processor_count

    def split_for(self, rows: int, inverse: bool) -> int:
        """Blocks per (limb, polynomial) for a call on ``rows`` of them:
        the least S at which two blocks share an SM and every SM of the
        card gets a block, at most :meth:`max_split`. Above FUSED_MAX_N,
        the least cluster: its grid has the fewest blocks (limbs·⌈polys /
        G⌉·S, G = S·2^14/N polynomials a cluster, is least there whatever
        the call), and a larger one, though it reads the weight tiles fewer
        times, waits on more blocks for each ring slot (slower on the
        H100: PERF.md)."""
        if self.n > FUSED_MAX_N:
            return self.splits[0]
        return pick_split(rows, self._sm_count, *self._split_range[inverse])

    def _call(self, x, limb_lo: int, inverse: bool, lazy: bool):
        if x.device.type == "cuda":
            return four_step_cuda(self, x, limb_lo, inverse, lazy)
        if x.device.type == "cpu":
            return four_step_plain(self, x, limb_lo, inverse, lazy)
        raise ValueError(f"no four-step NTT for device {x.device}")

    def ntt(self, x, lazy: bool = False):
        return self._call(x, 0, False, lazy)

    def intt(self, x, lazy: bool = False):
        return self._call(x, 0, True, lazy)

    def ntt_single(self, i: int, x, lazy: bool = False):
        return self._call(x, i, False, lazy)

    def intt_single(self, i: int, x, lazy: bool = False):
        return self._call(x, i, True, lazy)
