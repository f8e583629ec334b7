"""BGV/BFV encoder: SIMD batching over Z_T.

Counterpart of :mod:`lattigo_tpu.schemes.bgv.encoder`. Logical slot (r, j)
of the 2 × N/2 slot matrix is stored at the NTT evaluation point
ζ^{±5^j}; the permutation to the bit-reversed NTT slot order is
precomputed on the host. encode = permute → INTT over Z_T → centered lift
×T^{-1} into R_Q (MSB encoding); decode is the exact inverse.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lattigo_tpu_torch.ring import modops
from lattigo_tpu_torch.ring.basis_extension import ModUpConstants, mod_up
from lattigo_tpu_torch.ring.ntt import bit_reverse
from lattigo_tpu_torch.ring.ring import u64_tensor
from lattigo_tpu_torch.rlwe.elements import Plaintext
from lattigo_tpu_torch.schemes.bgv.params import Parameters


@functools.lru_cache(maxsize=None)
def _slot_permutation(n: int) -> np.ndarray:
    """perm[logical_slot] = NTT slot index. Row 0 holds exponents 5^j mod
    2N, row 1 exponents -5^j; NTT slot k evaluates at 2·brv(k)+1."""
    logn = n.bit_length() - 1
    two_n = 2 * n
    perm = np.zeros(n, dtype=np.int64)
    e = 1
    for j in range(n // 2):
        perm[j] = bit_reverse((e - 1) // 2, logn)
        perm[j + n // 2] = bit_reverse((two_n - e - 1) // 2, logn)
        e = e * 5 % two_n
    return perm


class Encoder:
    def __init__(self, params: Parameters):
        if params.ring_t is None:
            raise ValueError("batching requires T ≡ 1 mod 2N")
        self.params = params
        self.perm = _slot_permutation(params.n)
        self._perm_t = torch.from_numpy(self.perm).to(params.device)
        self._q_to_t: dict[int, ModUpConstants] = {}

    # -- Z_T slot transform ---------------------------------------------------

    def encode_ring_t(self, values) -> torch.Tensor:
        """values int[..., ≤N] (host) → coeffs of R_T, int64[..., 1, N]."""
        p = self.params
        vals = np.asarray(values)
        if vals.shape[-1] < p.n:
            pad = np.zeros(vals.shape[:-1] + (p.n - vals.shape[-1],), dtype=vals.dtype)
            vals = np.concatenate([vals, pad], axis=-1)
        vals = np.mod(vals.astype(object), p.t).astype(np.uint64)
        slots = np.zeros_like(vals)
        slots[..., self.perm] = vals
        return p.ring_t.intt(u64_tensor(slots, p.device)[..., None, :])

    def decode_ring_t(self, coeffs) -> torch.Tensor:
        """coeffs int64[..., 1, N] of R_T → slot values int64[..., N]."""
        evals = self.params.ring_t.ntt(coeffs)[..., 0, :]
        return evals[..., self._perm_t]

    # -- R_T ↔ R_Q lifts ------------------------------------------------------

    def ring_t_to_q(self, coeffs_t, level: int | None = None) -> torch.Tensor:
        """Centered lift of m ∈ R_T times T^{-1} mod Q (MSB encoding)."""
        p = self.params
        rq = p.ring_q
        l = (p.max_level if level is None else level) + 1
        q = rq.q[:l]
        bhi = rq.bred_hi[:l]
        x = coeffs_t
        pos = modops.bred_add(x, q, bhi)
        neg_mag = modops.bred_add(p.t - x, q, bhi)
        neg = torch.where(neg_mag == 0, neg_mag, q - neg_mag)
        lifted = torch.where(x > (p.t >> 1), neg, pos)
        return modops.mred(lifted, p.tinv_mont[:l], q, rq.qinv[:l], rq.small)

    def ring_q_to_t(self, poly_q, level: int) -> torch.Tensor:
        """[x·T]_Q centered → mod T, as a centered basis conversion Q → {T}."""
        p = self.params
        consts = self._q_to_t.get(level)
        if consts is None:
            consts = self._q_to_t[level] = ModUpConstants(
                p.q_moduli[: level + 1], [p.t], p.device)
        t_scaled = p.ring_q.mul_scalar(poly_q, p.t, level)
        rt = p.ring_t
        return mod_up(t_scaled, consts, rt.q, rt.qinv, rt.bred_hi, centered=True)

    # -- public API -------------------------------------------------------------

    def encode(self, values, level: int | None = None, scale: int = 1) -> Plaintext:
        p = self.params
        coeffs_t = self.encode_ring_t(values)
        if scale != 1:
            coeffs_t = p.ring_t.mul_scalar(coeffs_t, scale)
        pt_q = self.ring_t_to_q(coeffs_t, level)
        return Plaintext(value=p.ring_q.ntt(pt_q, level), is_ntt=True, scale=scale)

    def decode(self, pt: Plaintext) -> np.ndarray:
        """Slot values int64[..., N] on the host."""
        p = self.params
        v = pt.value
        if pt.is_ntt:
            v = p.ring_q.intt(v, pt.level)
        coeffs_t = self.ring_q_to_t(v, pt.level)
        if pt.scale != 1:
            coeffs_t = p.ring_t.mul_scalar(coeffs_t, pow(pt.scale, -1, p.t))
        return self.decode_ring_t(coeffs_t).cpu().numpy()
