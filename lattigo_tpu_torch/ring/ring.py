"""RNS ring construction and host-side precomputation.

Counterpart of :mod:`lattigo_tpu.ring.ring`: a :class:`Ring` is the
precomputation for Z_Q[X]/(X^N+1) with Q = ∏ q_i a chain of NTT-friendly
primes. Its tables are ``int64`` tensors (u64 bit patterns, ``[L, ...]``,
limb-major) built on the ring's ``device``; a polynomial is a tensor
``int64[..., level+1, N]``.

NTT engine, chosen in this order (:func:`select_engine`, the rule of the
JAX package's ``Ring._build_pallas``):

* ``mxu``: a STANDARD ring with 4096 ≤ N ≤ 65536 and every q < 2^29 uses
  the four-step digit-matmul engine (:mod:`.ntt_mxu`);
* ``u32``: a STANDARD ring with 512 ≤ N ≤ 2^15 and every q < 2^30 that
  the four-step engine did not take uses the fused u32 engine
  (:mod:`.ntt_pallas`);
* ``mxu64``: a STANDARD ring with N ≥ 4096 and every q < 2^61 that no
  kernel took uses the u64 four-step digit-matmul engine
  (:mod:`.ntt_u64_mxu`): library matmuls and torch elementwise ops, no
  kernel of this repository; on the card at N = 2^15 and 2^16 such a ring
  runs the u64 kernel (:mod:`.ntt_u64`, 64-bit Montgomery butterflies)
  instead, and builds no digit-matmul tables;
* ``radix2``: every other chain uses the plain radix-2 engine (:mod:`.ntt`).

A CONJUGATE_INVARIANT ring (``ring_type``) always takes the plain CI
transform (:mod:`.ntt_ci`, 4N-th roots), which has no kernel in either
package; ``ring.ntt_engine`` names it "ci-plain".

Each kernel engine runs its CUDA kernel on the card and its plain version
on the CPU; ``ring.ntt_engine`` names the choice (:func:`engine_name`). A
kernel that fails to build or launch raises; nothing falls back to another
engine.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from lattigo_tpu_torch.device import resolve_device
from lattigo_tpu_torch.ring import (modops, ntt as ntt_mod, ntt_ci, ntt_mxu, ntt_pallas,
                                    ntt_u64, ntt_u64_mxu)
from lattigo_tpu_torch.ring.modops import gen_bred_constant, gen_mred_constant
from lattigo_tpu_torch.trace import span
from lattigo_tpu_torch.utils.primes import primitive_nth_root

STANDARD = "standard"
CONJUGATE_INVARIANT = "conjugate_invariant"


def _mform_int(a: int, q: int) -> int:
    return (a << 64) % q


def u64_tensor(vals, device, shape=None) -> torch.Tensor:
    """Python ints / uint64 array in [0, 2^64) -> int64 tensor (same bits)."""
    a = np.asarray(vals, dtype=np.uint64)
    if shape is not None:
        a = a.reshape(shape)
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(device)


@dataclass(frozen=True)
class SubRing:
    """Per-prime precomputation."""

    n: int
    modulus: int
    mred_constant: int = field(init=False)
    bred_constant: tuple[int, int] = field(init=False)
    psi: int = field(init=False)

    def __post_init__(self):
        q, n = self.modulus, self.n
        if (q - 1) % (2 * n) != 0:
            raise ValueError(f"prime {q} is not NTT-friendly for N={n}")
        object.__setattr__(self, "mred_constant", gen_mred_constant(q))
        object.__setattr__(self, "bred_constant", gen_bred_constant(q))
        object.__setattr__(self, "psi", primitive_nth_root(q, 2 * n))

    def root_tables(self) -> tuple[np.ndarray, np.ndarray, int]:
        """(forward, inverse) bit-reversed Montgomery root tables + N^{-1}·R."""
        q, n, psi = self.modulus, self.n, self.psi
        ipsi = pow(psi, -1, q)
        pow_f = np.zeros(n, dtype=np.uint64)
        pow_i = np.zeros(n, dtype=np.uint64)
        p_f, p_i = 1, 1
        for j in range(n):
            pow_f[j] = _mform_int(p_f, q)
            pow_i[j] = _mform_int(p_i, q)
            p_f = p_f * psi % q
            p_i = p_i * ipsi % q
        brev = ntt_mod.bit_reverse_array(n.bit_length() - 1)
        return pow_f[brev], pow_i[brev], _mform_int(pow(n, -1, q), q)


def select_engine(n: int, moduli: list[int], ring_type: str = STANDARD) -> str:
    """The NTT engine a ring takes: "mxu", "u32", "mxu64" or "radix2"."""
    if ring_type != STANDARD:
        return "radix2"
    if (ntt_mxu.MIN_N <= n <= ntt_mxu.MAX_N
            and all(q < (1 << ntt_mxu.MAX_Q_BITS) for q in moduli)):
        return "mxu"
    if (ntt_pallas.MIN_N <= n <= ntt_pallas.MAX_N
            and all(q < (1 << ntt_pallas.MAX_Q_BITS) for q in moduli)):
        return "u32"
    if (n >= ntt_u64_mxu.MIN_N
            and all(q < (1 << ntt_u64_mxu.MAX_Q_BITS) for q in moduli)):
        return "mxu64"
    return "radix2"


def engine_name(n: int, moduli: list[int], device_type: str,
                ring_type: str = STANDARD) -> str:
    """The name :attr:`Ring.ntt_engine` reports for a ring of these
    parameters on a device of this type: "mxu-cuda" / "u32-cuda" (the
    four-step or u32 CUDA kernel), "mxu-plain" / "u32-plain" (its plain
    torch version, on the CPU), "u64-cuda" (an ``mxu64`` ring on the card
    at N = 2^15 or 2^16: the u64 CUDA kernel), "mxu64-plain" (every other
    ``mxu64`` ring: the u64 four-step engine, library matmuls),
    "radix2-plain" (the stage-by-stage engine) or "ci-plain" (the
    conjugate-invariant ring's transform)."""
    if ring_type != STANDARD:
        return "ci-plain"
    engine = select_engine(n, moduli, ring_type)
    if engine == "radix2":
        return "radix2-plain"
    if engine == "mxu64":
        return ("u64-cuda" if device_type == "cuda" and n in ntt_u64.SIZES
                else "mxu64-plain")
    return engine + ("-cuda" if device_type == "cuda" else "-plain")


class Ring:
    """RNS ring Z_Q[X]/(X^N+1), Q = ∏ moduli, with tables on ``device``.

    ``level`` arguments index the modulus chain (level L-1 = full chain).
    """

    def __init__(self, n: int, moduli: list[int], ring_type: str = STANDARD,
                 device=None):
        if n <= 0 or n & (n - 1):
            raise ValueError(f"N must be a power of two, got {n}")
        if len(set(moduli)) != len(moduli):
            raise ValueError("moduli must be distinct")
        if ring_type not in (STANDARD, CONJUGATE_INVARIANT):
            raise ValueError(f"unknown ring type {ring_type!r}")
        self.device = resolve_device(device)
        self.n = n
        self.log_n = n.bit_length() - 1
        self.ring_type = ring_type
        self.moduli = list(moduli)
        self.subrings = [SubRing(n, q) for q in moduli]
        #: every modulus < 2^30: modops takes the 32-bit Montgomery cascade
        self.small = max(moduli) < (1 << modops.SMALL_Q_BITS)

        L = len(moduli)
        dev = self.device
        self.q = u64_tensor(moduli, dev, (L, 1))
        self.qinv = u64_tensor([s.mred_constant for s in self.subrings], dev, (L, 1))
        self.bred_hi = u64_tensor([s.bred_constant[0] for s in self.subrings], dev, (L, 1))
        self.bred_lo = u64_tensor([s.bred_constant[1] for s in self.subrings], dev, (L, 1))
        fwd = np.zeros((L, n), dtype=np.uint64)
        inv = np.zeros((L, n), dtype=np.uint64)
        ninv = np.zeros((L, 1), dtype=np.uint64)
        for i, s in enumerate(self.subrings):
            fwd[i], inv[i], ninv[i, 0] = s.root_tables()
        self.roots = u64_tensor(fwd, dev)
        self.iroots = u64_tensor(inv, dev)
        self.ninv = u64_tensor(ninv, dev)

        # MForm(q_last^{-1} mod q_i) for every (last, i) pair (rescale).
        resc = np.zeros((L, L, 1), dtype=np.uint64)
        for last in range(1, L):
            ql = moduli[last]
            for i in range(last):
                resc[last, i, 0] = _mform_int(pow(ql, -1, moduli[i]), moduli[i])
        self.rescale_constants = u64_tensor(resc, dev)

        self.ci = ring_type == CONJUGATE_INVARIANT
        if self.ci:
            # per-limb CI transform tables (4N-th roots, see .ntt_ci)
            tabs = []
            for q in moduli:
                if (q - 1) % (4 * n) != 0:
                    raise ValueError(
                        f"prime {q} not NTT-friendly for the CI ring (4N)")
                tabs.append(ntt_ci.gen_ci_tables(n, primitive_nth_root(q, 4 * n), q))
            self.ci_roots = u64_tensor(np.stack([t[0] for t in tabs]), dev)
            self.ci_iroots = u64_tensor(np.stack([t[1] for t in tabs]), dev)
            self.ci_f_fwd = u64_tensor([t[2] for t in tabs], dev, (L, 1))
            self.ci_f_inv = u64_tensor([t[3] for t in tabs], dev, (L, 1))
            self.ci_ninv = u64_tensor([t[4] for t in tabs], dev, (L, 1))

        self._engine = select_engine(n, self.moduli, ring_type)
        self._engine_name = engine_name(n, self.moduli, dev.type, ring_type)
        psis = [s.psi for s in self.subrings]
        self._mxu = (ntt_mxu.NTTMxu(n, self.moduli, psis, dev)
                     if self._engine == "mxu" else None)
        self._u32 = (ntt_pallas.NTTPallas(n, self.moduli, psis, dev)
                     if self._engine == "u32" else None)
        self._mxu64 = (ntt_u64_mxu.NTTMxu64(n, self.moduli, psis, dev)
                       if self._engine_name == "mxu64-plain" else None)
        self._u64 = (ntt_u64.NTTU64(n, self.q, self.qinv, self.ninv, self.roots,
                                    self.iroots)
                     if self._engine_name == "u64-cuda" else None)
        #: the engine of this ring with ntt / intt / *_single entry points
        #: (four-step, u32, u64 four-step or u64 kernel), or None for radix-2
        self._kernel = self._mxu or self._u32 or self._mxu64 or self._u64

    # -- basic properties ---------------------------------------------------

    @property
    def ntt_engine(self) -> str:
        """The NTT engine (:func:`engine_name`)."""
        return self._engine_name

    @property
    def max_level(self) -> int:
        return len(self.moduli) - 1

    def modulus_at_level(self, level: int) -> int:
        return math.prod(self.moduli[: level + 1])

    def _lvl(self, level: int | None) -> int:
        return self.max_level if level is None else level

    def tables(self, level: int | None = None):
        l = self._lvl(level) + 1
        return self.q[:l], self.qinv[:l], self.bred_hi[:l], self.bred_lo[:l]

    # -- polynomial constructors --------------------------------------------

    def zero(self, level: int | None = None, batch: tuple[int, ...] = ()):
        """The zero polynomial int64[*batch, level+1, N]."""
        return torch.zeros(batch + (self._lvl(level) + 1, self.n),
                           dtype=torch.int64, device=self.device)

    def from_int_coeffs(self, coeffs, level: int | None = None):
        """Lift signed/unsigned Python-int coefficients into RNS residues,
        int64[level+1, N] on the ring's device."""
        l = self._lvl(level)
        out = np.array([[int(c) % q for c in coeffs]
                        for q in self.moduli[: l + 1]], dtype=np.uint64)
        return u64_tensor(out, self.device)

    def to_int_coeffs(self, poly, level: int | None = None,
                      centered: bool = True) -> list[int]:
        """CRT-reconstruct one [level+1, N] poly to Python ints (on the host;
        centered into (-Q/2, Q/2] unless ``centered`` is False)."""
        l = self._lvl(level)
        x = poly.detach().cpu().numpy().view(np.uint64)
        if x.ndim != 2:
            raise ValueError("to_int_coeffs expects a single [L, N] poly")
        big_q = self.modulus_at_level(l)
        acc = [0] * self.n
        for i in range(l + 1):
            qi = self.moduli[i]
            qh = big_q // qi
            lag = qh * pow(qh, -1, qi)
            row = x[i].tolist()
            acc = [(a + int(v) * lag) % big_q for a, v in zip(acc, row)]
        if centered:
            acc = [c - big_q if c > big_q // 2 else c for c in acc]
        return acc

    # -- elementwise ops ----------------------------------------------------

    def add(self, a, b, level: int | None = None):
        q, *_ = self.tables(level)
        return modops.add_mod(a, b, q)

    def sub(self, a, b, level: int | None = None):
        q, *_ = self.tables(level)
        return modops.sub_mod(a, b, q)

    def neg(self, a, level: int | None = None):
        q, *_ = self.tables(level)
        return modops.neg_mod(a, q)

    def mform(self, a, level: int | None = None):
        q, _, bhi, blo = self.tables(level)
        return modops.mform(a, q, bhi, blo)

    def imform(self, a, level: int | None = None):
        q, qinv, *_ = self.tables(level)
        return modops.imform(a, q, qinv)

    def mul_mont(self, a, b, level: int | None = None):
        """a·b with exactly one operand in Montgomery form."""
        q, qinv, *_ = self.tables(level)
        return modops.mred(a, b, q, qinv, self.small)

    def mul_mont_lazy(self, a, b, level: int | None = None):
        """:meth:`mul_mont` with a lazy output in [0, 2q)."""
        q, qinv, *_ = self.tables(level)
        return modops.mred_lazy(a, b, q, qinv, self.small)

    def mul_coeffs_barrett(self, a, b, level: int | None = None):
        """a·b mod q by Barrett reduction (neither operand in M-form)."""
        q, _, bhi, blo = self.tables(level)
        return modops.bred_mul(a, b, q, bhi, blo)

    def reduce(self, a, level: int | None = None):
        """a mod q for any 64-bit pattern a."""
        q, _, bhi, _ = self.tables(level)
        return modops.bred_add(a, q, bhi)

    def rns_scalar(self, scalar: int, level: int | None = None, mont: bool = True):
        """Host int -> int64[l+1, 1] residues (optionally Montgomery form)."""
        l = self._lvl(level)
        vals = [_mform_int(scalar % q, q) if mont else scalar % q
                for q in self.moduli[: l + 1]]
        return u64_tensor(vals, self.device, (l + 1, 1))

    def mul_scalar(self, a, scalar: int, level: int | None = None):
        """Multiply by a host integer scalar (RNS-lifted, Montgomery)."""
        q, qinv, *_ = self.tables(level)
        return modops.mred(a, self.rns_scalar(scalar, level), q, qinv, self.small)

    def mul_by_monomial(self, a, k: int, level: int | None = None):
        """a·X^k in the coefficient domain, any integer k: a negacyclic
        roll, the coefficients that wrap past X^N negated (X^N = −1)."""
        n = self.n
        shift = k % (2 * n)
        if shift == 0:
            return a
        q, *_ = self.tables(level)
        s = shift % n
        rolled = torch.roll(a, s, dims=-1) if s else a
        # rolled right by s, the first s outputs wrapped once; a shift in
        # [n, 2n) negates the whole polynomial once more
        wrapped = torch.arange(n, device=a.device) < s
        if shift >= n:
            wrapped = ~wrapped
        return torch.where(wrapped, modops.neg_mod(self.reduce(rolled, level), q),
                           rolled)

    # -- NTT ------------------------------------------------------------------

    def ntt(self, a, level: int | None = None, lazy: bool = False):
        with span("ring.ntt"):
            if self.ci:
                return self._ntt_ci(a, slice(0, self._lvl(level) + 1), lazy)
            if self._kernel is not None:
                return self._kernel.ntt(a.contiguous(), lazy=lazy)
            l = self._lvl(level) + 1
            return ntt_mod.ntt(a, self.roots[:l], self.q[:l], self.qinv[:l],
                               self.log_n, lazy=lazy, small=self.small)

    def intt(self, a, level: int | None = None, lazy: bool = False):
        with span("ring.ntt"):
            if self.ci:
                return self._intt_ci(a, slice(0, self._lvl(level) + 1), lazy)
            if self._kernel is not None:
                return self._kernel.intt(a.contiguous(), lazy=lazy)
            l = self._lvl(level) + 1
            return ntt_mod.intt(a, self.iroots[:l], self.ninv[:l], self.q[:l],
                                self.qinv[:l], self.log_n, lazy=lazy,
                                small=self.small)

    def ntt_single(self, i: int, a, lazy: bool = False):
        """NTT over subring i only; a has a singleton limb axis [..., 1, N]."""
        with span("ring.ntt"):
            if self.ci:
                return self._ntt_ci(a, slice(i, i + 1), lazy)
            if self._kernel is not None:
                return self._kernel.ntt_single(i, a.contiguous(), lazy=lazy)
            s = slice(i, i + 1)
            return ntt_mod.ntt(a, self.roots[s], self.q[s], self.qinv[s],
                               self.log_n, lazy=lazy, small=self.small)

    def intt_single(self, i: int, a, lazy: bool = False):
        with span("ring.ntt"):
            if self.ci:
                return self._intt_ci(a, slice(i, i + 1), lazy)
            if self._kernel is not None:
                return self._kernel.intt_single(i, a.contiguous(), lazy=lazy)
            s = slice(i, i + 1)
            return ntt_mod.intt(a, self.iroots[s], self.ninv[s], self.q[s],
                                self.qinv[s], self.log_n, lazy=lazy,
                                small=self.small)

    def _ntt_ci(self, a, s: slice, lazy: bool):
        return ntt_ci.ntt_ci(a, self.ci_roots[s], self.ci_f_fwd[s], self.q[s],
                             self.qinv[s], self.log_n, lazy=lazy, small=self.small)

    def _intt_ci(self, a, s: slice, lazy: bool):
        return ntt_ci.intt_ci(a, self.ci_iroots[s], self.ci_f_inv[s],
                              self.ci_ninv[s], self.q[s], self.qinv[s],
                              self.log_n, lazy=lazy, small=self.small)
