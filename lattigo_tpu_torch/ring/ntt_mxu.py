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
* the CUDA kernel ``csrc/ntt_mxu.cu``, launched by :func:`four_step_cuda`.

:class:`NTTMxu` sends a CPU tensor to the plain version and a CUDA tensor
to the kernel; there is no fallback between them. Requires q < 2^29 and
4096 ≤ N ≤ 16384 (the kernel's shared-memory layout). Lazy outputs are in
[0, 2q), otherwise [0, q).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lattigo_tpu_torch import build
from lattigo_tpu_torch.device import resolve_device
from lattigo_tpu_torch.ring.ntt import bit_reverse

MAX_Q_BITS = 29
MIN_N = 4096
MAX_N = 1 << 14
M8 = 0xFF
M16 = 0xFFFF
M32 = 0xFFFFFFFF

#: Launch counts of the CUDA kernel, by direction. Each launch adds one;
#: the plain version adds nothing.
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
    """
    logr = rr.bit_length() - 1
    logc = cc.bit_length() - 1
    w = psi * psi % q
    wi = pow(w, -1, q)
    psii = pow(psi, -1, q)
    ninv = pow(n, -1, q)

    brev_r = np.array([bit_reverse(t, logr) for t in range(rr)])
    brev_c = np.array([bit_reverse(t, logc) for t in range(cc)])

    u = _pow_table(pow(w, cc, q), rr, q)
    psic = _pow_table(pow(psi, cc, q), rr, q)
    wa = (u[np.outer(brev_r, np.arange(rr)) % rr].astype(object)
          * psic[None, :].astype(object)) % q
    wp = _pow_table(w, n, q)
    psip = _pow_table(psi, cc, q)
    tf = (wp[np.outer(brev_r, np.arange(cc)) % n].astype(object)
          * psip[None, :cc].astype(object)) % q
    v = _pow_table(pow(w, rr, q), cc, q)
    wb = v[np.outer(np.arange(cc), brev_c) % cc]

    ui = _pow_table(pow(wi, rr, q), cc, q)
    wbi = ui[np.outer(brev_c, np.arange(cc)) % cc]
    wpi = _pow_table(wi, n, q)
    psiip = _pow_table(psii, cc, q)
    ti = (wpi[np.outer(brev_r, np.arange(cc)) % n].astype(object)
          * psiip[None, :cc].astype(object)) % q
    uii = _pow_table(pow(wi, cc, q), rr, q)
    psici = _pow_table(pow(psii, cc, q), rr, q)
    wai = uii[np.outer(np.arange(rr), brev_r) % rr].astype(object) \
        * psici[:, None].astype(object) % q
    wai = wai * ninv % q

    def as_u64(a):
        return np.asarray(a, dtype=object).astype(np.uint64)

    return dict(wa=as_u64(wa), tf=as_u64(tf), wb=as_u64(wb),
                wbi=as_u64(wbi), ti=as_u64(ti), wai=as_u64(wai))


def gen_mxu_tables(n: int, rr: int, cc: int, psi: int, q: int):
    """Per-prime constant pack: int8 digit extensions of the raw weights
    (same layouts as the TPU kernel's) + Montgomery-form (2^32) twiddles."""
    raw = gen_four_step_weights(n, rr, cc, psi, q)
    mont = np.vectorize(lambda x: _mform32(int(x), q), otypes=[np.uint32])
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


# ---------------------------------------------------------------------------
# Plain torch version
# ---------------------------------------------------------------------------

def _mred_lazy32(a, b, q, qinv):
    """u32 a·b·2^{-32} mod q in [0, 2q) on int64 tensors holding u32
    values; needs a·b < q·2^32 (the product may wrap int64: masked)."""
    ab = a * b
    hi = (ab >> 32) & M32
    m = ((ab & M32) * qinv) & M32
    mh = (m * q) >> 32
    return (hi - mh + q) & M32


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


def _library():
    lib = build.load("ntt_mxu")
    fn = lib.ntt_mxu_launch
    if fn.argtypes is None:
        fn.argtypes = [_ptr] * 6 + [_int] * 6 + [_ptr]
        fn.restype = _int
    return fn


def four_step_cuda(eng: "NTTMxu", x, limb_lo: int, inverse: bool,
                   lazy: bool):
    """Launch ``csrc/ntt_mxu.cu`` on x int64[..., l, N] (CUDA, contiguous)."""
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
    out = torch.empty_like(x)
    blocks = x.numel() // eng.n
    if blocks == 0:
        return out
    if inverse:
        w1, tw, w2 = eng.w1i_t, eng.ti_t, eng.w2i
    else:
        w1, tw, w2 = eng.w1f, eng.tf, eng.w2f_t
    fn = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), eng.consts.data_ptr(),
                 w1.data_ptr(), tw.data_ptr(), w2.data_ptr(), eng.logn,
                 int(inverse), int(lazy), blocks, l, limb_lo, stream)
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
    int32 ``tf`` [L, R, C] and ``ti_t`` [L, C, R] (TI transposed).
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
        packs = [gen_mxu_tables(n, self.rr, self.cc, psi, q)
                 for psi, q in zip(psis, moduli)]

        def stack(key, conv, transpose=False):
            a = np.stack([p[key] for p in packs])
            if transpose:
                a = a.transpose(0, 2, 1)
            return conv(a).to(self.device)

        self.consts = _i32(gen_consts(moduli)).to(self.device)
        self.w1f = stack("w1f", _i8)
        self.w2f_t = stack("w2f", _i8, transpose=True)
        self.w1i_t = stack("w1i", _i8, transpose=True)
        self.w2i = stack("w2i", _i8)
        self.tf = stack("tf", _i32)
        self.ti_t = stack("ti", _i32, transpose=True)

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
