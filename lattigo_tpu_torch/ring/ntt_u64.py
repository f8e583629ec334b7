"""Negacyclic NTT/INTT of u64 residues (q < 2^61) at N = 2^15 and 2^16 on
the card: the CUDA kernel ``csrc/ntt_u64.cu``.

It replaces no Pallas kernel: the JAX package runs this transform at the
XLA level (:mod:`lattigo_tpu.ring.ntt_u64_mxu`, int8 digit matmuls for the
TPU's matrix unit). On the card every ring that takes the ``mxu64`` engine
at these sizes runs the radix-2 lazy Harvey transform of :mod:`.ntt` in
this kernel instead, with 64-bit Montgomery butterflies on the integer
pipes, in two launches a call (a column pass and a row pass). It reads the
ring's own tables: ``Ring.roots`` / ``Ring.iroots``, ``Ring.ninv``,
``Ring.q`` and ``Ring.qinv``.

Contract, the u64 four-step engine's (:mod:`.ntt_u64_mxu`): inputs in
[0, 2q); outputs in [0, q), or [0, 2q) when lazy. Non-lazy outputs are
canonical, so they equal every other engine's; lazy ones agree mod q.

Two implementations of the same function live here:

* :func:`u64_plain`: :func:`.ntt.ntt` / :func:`.ntt.intt` on the 64-bit
  Montgomery route (``small=False``, whatever the primes' widths), the
  forward's lazy [0, 4q) folded once more into [0, 2q);
* the CUDA kernel, launched by :func:`u64_cuda`, which raises on anything
  it does not take; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lattigo_tpu_torch import build
from lattigo_tpu_torch.ring import ntt as ntt_mod

#: The ring degrees the kernel has.
SIZES = (1 << 15, 1 << 16)
#: Launches of the CUDA kernel, by direction: two a call (column and row
#: pass); the plain version adds nothing.
LAUNCHES = {"forward": 0, "inverse": 0}
LAUNCHES_PER_CALL = 2


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def u64_plain(eng: "NTTU64", x, limb_lo: int, inverse: bool, lazy: bool):
    """The kernel's function in plain torch: x int64[..., l, N] -> same."""
    s = slice(limb_lo, limb_lo + x.shape[-2])
    q, qinv = eng.q[s], eng.qinv[s]
    if inverse:
        return ntt_mod.intt(x, eng.iroots[s], eng.ninv[s], q, qinv, eng.logn,
                            lazy=lazy, small=False)
    y = ntt_mod.ntt(x, eng.roots[s], q, qinv, eng.logn, lazy=lazy, small=False)
    if lazy:
        q2 = q + q
        y = torch.where(y >= q2, y - q2, y)
    return y


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_ptr = ctypes.c_void_p
_int = ctypes.c_int


class _Engine(ctypes.Structure):
    """``NttU64Engine`` of ``csrc/ntt_u64.cu``."""
    _fields_ = [("q", _ptr), ("qinv", _ptr), ("ninv", _ptr), ("roots", _ptr),
                ("iroots", _ptr), ("logn", _int), ("device", _int)]


class _Binding:
    """What a launch needs beyond its tensors, resolved once per engine:
    the C function and the ring's tables, logN and device as one C struct
    (``ptr`` is its address; the engine keeps the tables alive)."""

    def __init__(self, eng: "NTTU64"):
        fn = build.load("ntt_u64").ntt_u64_launch
        fn.argtypes = [_ptr] * 3 + [_int] * 4 + [_ptr]
        fn.restype = _int
        self.fn = fn
        self.device = eng.device.index
        self.engine = _Engine(eng.q.data_ptr(), eng.qinv.data_ptr(),
                              eng.ninv.data_ptr(), eng.roots.data_ptr(),
                              eng.iroots.data_ptr(), eng.logn, self.device)
        self.ptr = ctypes.addressof(self.engine)


def u64_cuda(eng: "NTTU64", x, limb_lo: int, inverse: bool, lazy: bool):
    """Launch ``csrc/ntt_u64.cu`` on x int64[..., l, N] (on the engine's
    CUDA device, contiguous): two launches on that device's current stream,
    the output allocated here; no host copy, no synchronization."""
    if x.dtype != torch.int64:
        raise TypeError(f"u64 NTT kernel takes int64 residues, got {x.dtype}")
    if x.device != eng.device:
        raise ValueError(f"tensor on {x.device}, tables on {eng.device}")
    shape = x.shape
    if len(shape) < 2 or shape[-1] != eng.n:
        raise ValueError(f"expected [..., limbs, {eng.n}], got {tuple(shape)}")
    l = shape[-2]
    if l < 1 or limb_lo < 0 or limb_lo + l > eng.limbs:
        raise ValueError(f"limbs [{limb_lo}, {limb_lo + l}) outside the "
                         f"{eng.limbs}-limb table")
    if not x.is_contiguous():
        raise ValueError("u64 NTT kernel needs a contiguous tensor")
    out = torch.empty_like(x)
    rows = x.numel() // eng.n
    if rows == 0:
        return out
    k = eng._binding
    err = k.fn(x.data_ptr(), out.data_ptr(), k.ptr, inverse | lazy << 1, rows, l,
               limb_lo, torch.cuda.current_stream(k.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"u64 NTT kernel launch failed: CUDA error {err}")
    LAUNCHES["inverse" if inverse else "forward"] += LAUNCHES_PER_CALL
    return out


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class NTTU64:
    """A ring's entry points on the kernel, over the ring's own tables:
    ``q``, ``qinv``, ``ninv`` int64 [L, 1] and ``roots``, ``iroots`` int64
    [L, N] (u64 bit patterns, on one CUDA device)."""

    def __init__(self, n: int, q, qinv, ninv, roots, iroots):
        if n not in SIZES:
            raise ValueError(f"the u64 NTT kernel has N in {SIZES}, not {n}")
        tabs = (q, qinv, ninv, roots, iroots)
        if any(t.dtype != torch.int64 or not t.is_contiguous() or t.device != q.device
               for t in tabs):
            raise ValueError("the ring's tables must be contiguous int64 on one device")
        self.n = n
        self.logn = n.bit_length() - 1
        self.limbs = q.shape[0]
        self.device = q.device
        self.q, self.qinv, self.ninv, self.roots, self.iroots = tabs

    @functools.cached_property
    def _binding(self) -> _Binding:
        return _Binding(self)

    def ntt(self, x, lazy: bool = False):
        return u64_cuda(self, x, 0, False, lazy)

    def intt(self, x, lazy: bool = False):
        return u64_cuda(self, x, 0, True, lazy)

    def ntt_single(self, i: int, x, lazy: bool = False):
        return u64_cuda(self, x, i, False, lazy)

    def intt_single(self, i: int, x, lazy: bool = False):
        return u64_cuda(self, x, i, True, lazy)
