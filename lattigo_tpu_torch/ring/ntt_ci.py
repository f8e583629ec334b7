"""Negacyclic NTT of the conjugate-invariant ring Z[X+X^{-1}]/(X^{2N}+1).

Counterpart of :mod:`lattigo_tpu.ring.ntt_ci`: a ring element is stored as
N coefficients (c_0, …, c_{N−1}) ↦ c_0 + Σ_{j≥1} c_j·(X^j − X^{2N−j}), the
fixed ring of X → X^{−1} inside Z[X]/(X^{2N}+1), and its NTT is the N-point
"left half" of the 2N-point transform:

* forward: one folding pre-stage with F = ψ^{brev(1)} (ψ a 4N-th root),
  y[j] = x[j] − F·x[N−j] (j ≥ 1, y[0] = x[0]), then the radix-2 stages of
  :mod:`.ntt`, stage s reading its roots from the 4N-root table at offset
  2^{s+1} (the kept half of the size-2N transform's stage s+1);
* inverse: the mirrored stages, the inverse pre-stage, x[0] doubled and a
  final multiply by (2N)^{-1}.

The stage loop is the plain engine's, over a REMAPPED table
roots_eff[2^s + g] = table_4N[2^{s+1} + g]. The JAX package runs this
transform as whole-array XLA (its TPU kernels take standard rings only);
here it is plain torch on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from lattigo_tpu_torch.ring.modops import cred, mred, mred_lazy
from lattigo_tpu_torch.ring.ntt import _fwd_stage, _inv_stage, bit_reverse_array


def _mform_int(a: int, q: int) -> int:
    return (a << 64) % q


def gen_ci_tables(n: int, psi4n: int, q: int):
    """(fwd_remap u64[N], inv_remap u64[N], F_fwd, F_inv, ninv) for one
    prime: the size-2N bit-reversed Montgomery tables of the 4N-th root
    (and its inverse), remapped so the stage loop indexes them as size-N
    tables, the two pre-stage factors and MForm((2N)^{-1})."""
    log2n = n.bit_length()              # log2(2N)
    brev = bit_reverse_array(log2n)

    def table(base):
        pows = [1] * (2 * n)
        for j in range(1, 2 * n):
            pows[j] = pows[j - 1] * base % q
        return np.array([_mform_int(pows[r], q) for r in brev], dtype=np.uint64)

    t_f = table(psi4n)
    t_i = table(pow(psi4n, -1, q))
    fwd = np.zeros(n, dtype=np.uint64)
    inv = np.zeros(n, dtype=np.uint64)
    for s in range(log2n - 1):          # the N-point transform's stages
        m = 1 << s
        fwd[m: 2 * m] = t_f[2 * m: 3 * m]
        inv[m: 2 * m] = t_i[2 * m: 3 * m]
    # (2N)^{-1}: the inverse pre-stage doubles index 0, netting N^{-1} there
    ninv = _mform_int(pow(2 * n, -1, q), q)
    return fwd, inv, int(t_f[1]), int(t_i[1]), ninv


def _fold_partner(x):
    """partner[j] = x[(N − j) mod N] along the last axis."""
    return torch.roll(torch.flip(x, dims=(-1,)), 1, dims=-1)


def ntt_ci(x, roots_remap, f_fwd, q, qinv, logn: int, lazy: bool = False,
           small: bool | None = None):
    """Forward CI NTT of int64[..., L, N] coefficients in [0, q).

    roots_remap: int64[L, N]; f_fwd, q, qinv: int64[L, 1]. Lazy output is in
    [0, 4q), else [0, q).
    """
    small = bool(int(q.max()) < (1 << 30)) if small is None else small
    q2 = q + q
    y = x + q2 - mred_lazy(_fold_partner(x), f_fwd, q, qinv, small)
    y[..., 0] = x[..., 0]
    for s in range(logn):
        m = 1 << s
        y = _fwd_stage(y, roots_remap[..., m:2 * m, None], q2, q, qinv, m, small)
    if lazy:
        return y
    y = torch.where(y >= q2, y - q2, y)
    return cred(y, q)


def intt_ci(v, iroots_remap, f_inv, ninv_mont, q, qinv, logn: int,
            lazy: bool = False, small: bool | None = None):
    """Inverse CI NTT; lazy output is in [0, 2q), else [0, q)."""
    small = bool(int(q.max()) < (1 << 30)) if small is None else small
    q2 = q + q
    x = v
    for s in range(logn - 1, -1, -1):
        m = 1 << s
        x = _inv_stage(x, iroots_remap[..., m:2 * m, None], q2, q, qinv, m, small)
    # inverse pre-stage: x[j] − F⁻¹·x[N−j], x[0] doubled
    y = x + q2 - mred_lazy(_fold_partner(x), f_inv, q, qinv, small)
    y[..., 0] = cred(x[..., 0] * 2, q2[..., 0])
    if lazy:
        return mred_lazy(y, ninv_mont, q, qinv, small)
    return mred(y, ninv_mont, q, qinv, small)
