"""Fused negacyclic NTT/INTT with u32 Montgomery arithmetic (u32 engine).

Counterpart of :mod:`lattigo_tpu.ring.ntt_pallas` (the TPU's fused u32
kernels ``_ntt_kernel`` / ``_intt_kernel``). All logN radix-2 stages run on
a row that stays in fast memory, with 32-bit Montgomery products
(R = 2^32). Requires every q < 2^30 (the forward lazy bound 4q fits in 32
bits) and 512 ≤ N ≤ 2^15.

Forward stage with m groups (pair stride t = N/2m), lower position p and
upper p + t, w = MForm32(ψ^{brev(m+g)}) for group g:

    x0, x1 = fold(x[p]), fold(x[p+t])          # fold: [0, 4q) -> [0, 2q)
    u = MRedLazy32(x1, w)                      # [0, 2q)
    x[p], x[p+t] = x0 + u, x0 - u + 2q         # [0, 4q)

Inverse stage (m = N/2 … 1, w = MForm32(ψ^{-brev(m+g)})):

    x[p], x[p+t] = fold(x0 + x1), MRedLazy32(x0 - x1 + 2q, w)   # [0, 2q)

then ×N^{-1} on the Montgomery exit. Both repeat the TPU kernel's
arithmetic step for step, so lazy outputs are the same integers: the
forward's in [0, 4q), the inverse's in [0, 2q); otherwise [0, q). Inputs
are read as their low 32 bits. The forward takes [0, 4q) (it folds once
from there); the inverse takes [0, 2q): on an input in [2q, 4q), such as a
lazy forward output, it returns other integers than the input's residue
would give, in both packages, so a lazy forward output must not go to the
inverse unreduced.

The TPU kernel spreads the stage roots over ``[logN, N]`` tables for its
roll-and-select butterflies; here one compact per-limb table of N roots
serves every stage (group g of the stage with m groups reads entry m+g).

Two implementations of the same function live here:

* :func:`u32_plain`: plain torch, stage by stage, u32 values in int64
  tensors (a product of two u32 values may wrap int64; its high word is
  read with a masked shift);
* the CUDA kernel ``csrc/ntt_pallas.cu``, launched by :func:`u32_cuda`.

:class:`NTTPallas` sends a CPU tensor to the plain version and a CUDA
tensor to the kernel; there is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from lattigo_tpu_torch import build
from lattigo_tpu_torch.device import resolve_device
from lattigo_tpu_torch.ring.ntt import bit_reverse_array

MAX_Q_BITS = 30
MIN_N = 512
MAX_N = 1 << 15
M32 = 0xFFFFFFFF

#: Launch counts of the CUDA kernel, by direction. Each launch adds one;
#: the plain version adds nothing.
LAUNCHES = {"forward": 0, "inverse": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Host-side tables
# ---------------------------------------------------------------------------

def _mform32(a: int, q: int) -> int:
    return (a << 32) % q


def gen_roots32(n: int, psi: int, q: int, inverse: bool) -> np.ndarray:
    """uint32[N]: entry k = MForm32(ψ^{±brev(k)}), ψ^{-1} when ``inverse``."""
    base = pow(psi, -1, q) if inverse else psi
    pows = [1] * n
    for j in range(1, n):
        pows[j] = pows[j - 1] * base % q
    brev = bit_reverse_array(n.bit_length() - 1)
    return np.array([_mform32(pows[int(b)], q) for b in brev], dtype=np.uint32)


def gen_consts32(n: int, moduli: list[int]) -> np.ndarray:
    """uint32 [L, 4]: q, q^{-1} mod 2^32, MForm32(N^{-1}), 0 (padding)."""
    c = np.zeros((len(moduli), 4), dtype=np.uint32)
    for i, q in enumerate(moduli):
        c[i, 0] = q
        c[i, 1] = pow(q, -1, 1 << 32)
        c[i, 2] = _mform32(pow(n, -1, q), q)
    return c


# ---------------------------------------------------------------------------
# Plain torch version
# ---------------------------------------------------------------------------

def mred_lazy32(a, b, q, qinv):
    """u32 a·b·2^{-32} mod q in [0, 2q) on int64 tensors holding u32
    values (needs a·b < q·2^32); every step wraps mod 2^32 as the u32
    kernels do."""
    ab = a * b
    hi = (ab >> 32) & M32
    m = ((ab & M32) * qinv) & M32
    mh = (m * q) >> 32
    return (hi - mh + q) & M32


def _fold(x, bound):
    return torch.where(x >= bound, x - bound, x)


def u32_plain(eng: "NTTPallas", x, limb_lo: int, inverse: bool, lazy: bool):
    """The kernel's function in plain torch: x int64[..., l, N] -> same."""
    shape = x.shape
    l, n = shape[-2], eng.n
    sl = slice(limb_lo, limb_lo + l)
    c = eng.consts[sl].to(torch.int64) & M32
    q, qinv, ninv = (c[:, i].reshape(l, 1, 1) for i in range(3))
    q2 = q + q
    roots = (eng.iroots if inverse else eng.roots)[sl].to(torch.int64) & M32
    x = x.reshape(-1, l, n) & M32
    stages = range(eng.logn - 1, -1, -1) if inverse else range(eng.logn)
    for s in stages:
        m = 1 << s
        xv = x.reshape(-1, l, m, 2, n // (2 * m))
        x0, x1 = xv[..., 0, :], xv[..., 1, :]
        w = roots[:, m:2 * m, None]                                 # [l, m, 1]
        if inverse:
            y0 = _fold((x0 + x1) & M32, q2)
            y1 = mred_lazy32((x0 - x1 + q2) & M32, w, q, qinv)
        else:
            x0, x1 = _fold(x0, q2), _fold(x1, q2)
            u = mred_lazy32(x1, w, q, qinv)
            y0, y1 = (x0 + u) & M32, (x0 - u + q2) & M32
        x = torch.stack([y0, y1], dim=-2).reshape(-1, l, n)
    q, ninv = q.reshape(l, 1), ninv.reshape(l, 1)
    if inverse:
        x = mred_lazy32(x, ninv, q, qinv.reshape(l, 1))
        if not lazy:
            x = _fold(x, q)
    elif not lazy:
        x = _fold(_fold(x, q + q), q)
    return x.reshape(shape)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_ptr = ctypes.c_void_p
_int = ctypes.c_int


class _Engine(ctypes.Structure):
    """``NttU32Engine`` of ``csrc/ntt_pallas.cu``."""
    _fields_ = [("consts", _ptr), ("roots", _ptr), ("iroots", _ptr),
                ("logn", _int), ("device", _int)]


class _Binding:
    """What a launch needs beyond its tensors, resolved once per engine:
    the C function and the engine's tables, logN and device as one C
    struct (``ptr`` is its address; the engine keeps the tables alive)."""

    def __init__(self, eng: "NTTPallas"):
        fn = build.load("ntt_pallas").ntt_u32_launch
        fn.argtypes = [_ptr] * 3 + [_int] * 4 + [_ptr]
        fn.restype = _int
        self.fn = fn
        self.device = eng.device.index
        self.engine = _Engine(eng.consts.data_ptr(), eng.roots.data_ptr(),
                              eng.iroots.data_ptr(), eng.logn, self.device)
        self.ptr = ctypes.addressof(self.engine)


def u32_cuda(eng: "NTTPallas", x, limb_lo: int, inverse: bool, lazy: bool):
    """Launch ``csrc/ntt_pallas.cu`` on x int64[..., l, N] (CUDA, contiguous,
    16-byte aligned). The kernel makes ``x.device`` current for its launch
    when it is not, on that device's current stream."""
    if x.dtype != torch.int64:
        raise TypeError(f"u32 NTT kernel takes int64 residues, got {x.dtype}")
    if x.device != eng.device:
        raise ValueError(f"tensor on {x.device}, tables on {eng.device}")
    shape = x.shape
    if len(shape) < 2 or shape[-1] != eng.n:
        raise ValueError(f"expected [..., limbs, {eng.n}], got {tuple(shape)}")
    l = shape[-2]
    if limb_lo < 0 or limb_lo + l > eng.limbs:
        raise ValueError(f"limbs [{limb_lo}, {limb_lo + l}) outside the "
                         f"{eng.limbs}-limb table")
    if not x.is_contiguous():
        raise ValueError("u32 NTT kernel needs a contiguous tensor")
    ptr = x.data_ptr()
    if ptr % 16:
        raise ValueError("u32 NTT kernel needs a 16-byte aligned tensor")
    out = torch.empty_like(x)
    rows = x.numel() // eng.n
    if rows == 0:
        return out
    k = eng._binding
    err = k.fn(ptr, out.data_ptr(), k.ptr, inverse | lazy << 1, rows, l,
               limb_lo, torch.cuda.current_stream(k.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"u32 NTT kernel launch failed: CUDA error {err}")
    LAUNCHES["inverse" if inverse else "forward"] += 1
    return out


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


class NTTPallas:
    """Per-ring u32 tables and entry points.

    Tables on ``device`` (u32 bit patterns in int32): ``consts`` [L, 4]
    (:func:`gen_consts32`), ``roots`` and ``iroots`` [L, N]
    (:func:`gen_roots32`).
    """

    def __init__(self, n: int, moduli: list[int], psis: list[int], device):
        if not all(q < (1 << MAX_Q_BITS) for q in moduli):
            raise ValueError("the u32 NTT needs every q < 2^30")
        if not (MIN_N <= n <= MAX_N and n & (n - 1) == 0):
            raise ValueError(f"the u32 NTT needs N in [{MIN_N}, {MAX_N}]")
        self.device = resolve_device(device)
        self.n = n
        self.logn = n.bit_length() - 1
        self.limbs = len(moduli)
        self.consts = _i32(gen_consts32(n, moduli)).to(self.device)
        self.roots = _i32(np.stack([gen_roots32(n, psi, q, False)
                                    for psi, q in zip(psis, moduli)])).to(self.device)
        self.iroots = _i32(np.stack([gen_roots32(n, psi, q, True)
                                     for psi, q in zip(psis, moduli)])).to(self.device)

    @functools.cached_property
    def _binding(self) -> _Binding:
        return _Binding(self)

    def _call(self, x, limb_lo: int, inverse: bool, lazy: bool):
        if x.device.type == "cuda":
            return u32_cuda(self, x, limb_lo, inverse, lazy)
        if x.device.type == "cpu":
            return u32_plain(self, x, limb_lo, inverse, lazy)
        raise ValueError(f"no u32 NTT for device {x.device}")

    def ntt(self, x, lazy: bool = False):
        return self._call(x, 0, False, lazy)

    def intt(self, x, lazy: bool = False):
        return self._call(x, 0, True, lazy)

    def ntt_single(self, i: int, x, lazy: bool = False):
        return self._call(x, i, False, lazy)

    def intt_single(self, i: int, x, lazy: bool = False):
        return self._call(x, i, True, lazy)
