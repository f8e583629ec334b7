"""RNS ring construction and host-side precomputation.

Counterpart of :mod:`lattigo_tpu.ring.ring`: a :class:`Ring` is the
precomputation for Z_Q[X]/(X^N+1) with Q = ∏ q_i a chain of NTT-friendly
primes. Its tables are ``int64`` tensors (u64 bit patterns, ``[L, ...]``,
limb-major) built on the ring's ``device``; a polynomial is a tensor
``int64[..., level+1, N]``.

NTT engine: a STANDARD ring with 4096 ≤ N ≤ 16384 and every q < 2^29 uses
the four-step digit-matmul engine (:mod:`.ntt_mxu`, whose CUDA kernel runs
on the card and whose plain version runs on the CPU). Every other chain
uses the plain radix-2 engine (:mod:`.ntt`). ``ring.ntt_engine`` names the
choice. A kernel that fails to build or launch raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from lattigo_tpu_torch.device import resolve_device
from lattigo_tpu_torch.ring import modops, ntt as ntt_mod, ntt_mxu
from lattigo_tpu_torch.ring.modops import gen_bred_constant, gen_mred_constant
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
        if ring_type != STANDARD:
            raise NotImplementedError(
                "the conjugate-invariant ring is not ported yet")
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

        self._mxu = None
        if (ntt_mxu.MIN_N <= n <= ntt_mxu.MAX_N
                and all(q < (1 << ntt_mxu.MAX_Q_BITS) for q in moduli)):
            self._mxu = ntt_mxu.NTTMxu(n, self.moduli,
                                       [s.psi for s in self.subrings], dev)

    # -- basic properties ---------------------------------------------------

    @property
    def ntt_engine(self) -> str:
        """The NTT engine: "mxu-cuda" (the four-step CUDA kernel),
        "mxu-plain" (its plain torch version, on the CPU) or "radix2-plain"
        (the stage-by-stage engine)."""
        if self._mxu is None:
            return "radix2-plain"
        return "mxu-cuda" if self.device.type == "cuda" else "mxu-plain"

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

    # -- elementwise ops ----------------------------------------------------

    def add(self, a, b, level: int | None = None):
        q, *_ = self.tables(level)
        return modops.add_mod(a, b, q)

    def sub(self, a, b, level: int | None = None):
        q, *_ = self.tables(level)
        return modops.sub_mod(a, b, q)

    def mform(self, a, level: int | None = None):
        q, _, bhi, blo = self.tables(level)
        return modops.mform(a, q, bhi, blo)

    def mul_mont(self, a, b, level: int | None = None):
        """a·b with exactly one operand in Montgomery form."""
        q, qinv, *_ = self.tables(level)
        return modops.mred(a, b, q, qinv, self.small)

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

    # -- NTT ------------------------------------------------------------------

    def ntt(self, a, level: int | None = None, lazy: bool = False):
        if self._mxu is not None:
            return self._mxu.ntt(a.contiguous(), lazy=lazy)
        l = self._lvl(level) + 1
        return ntt_mod.ntt(a, self.roots[:l], self.q[:l], self.qinv[:l],
                           self.log_n, lazy=lazy, small=self.small)

    def intt(self, a, level: int | None = None, lazy: bool = False):
        if self._mxu is not None:
            return self._mxu.intt(a.contiguous(), lazy=lazy)
        l = self._lvl(level) + 1
        return ntt_mod.intt(a, self.iroots[:l], self.ninv[:l], self.q[:l],
                            self.qinv[:l], self.log_n, lazy=lazy,
                            small=self.small)

    def ntt_single(self, i: int, a, lazy: bool = False):
        """NTT over subring i only; a has a singleton limb axis [..., 1, N]."""
        if self._mxu is not None:
            return self._mxu.ntt_single(i, a.contiguous(), lazy=lazy)
        s = slice(i, i + 1)
        return ntt_mod.ntt(a, self.roots[s], self.q[s], self.qinv[s],
                           self.log_n, lazy=lazy, small=self.small)

    def intt_single(self, i: int, a, lazy: bool = False):
        if self._mxu is not None:
            return self._mxu.intt_single(i, a.contiguous(), lazy=lazy)
        s = slice(i, i + 1)
        return ntt_mod.intt(a, self.iroots[s], self.ninv[s], self.q[s],
                            self.qinv[s], self.log_n, lazy=lazy,
                            small=self.small)
