"""Negacyclic NTT / INTT as stage-by-stage torch programs (plain engine).

Counterpart of :mod:`lattigo_tpu.ring.ntt`: the radix-2 lazy Harvey NTT.
At stage ``s`` the coefficient axis is viewed as ``[m, 2, t]`` (``m = 2^s``
groups, pair stride ``t = N/2m``) and one butterfly runs over the whole
tensor. Forward butterflies keep coefficients in [0, 4q), the inverse in
[0, 2q); ``q < 2^61`` keeps every value below 2^63. Root tables are
bit-reverse-ordered powers of the 2N-th root in Montgomery form.

``ntt`` maps natural coefficient order to bit-reversed evaluation order;
``intt`` inverts it. This engine serves every chain that no kernel takes.
"""

from __future__ import annotations

import numpy as np
import torch

from lattigo_tpu_torch.ring.modops import cred, mred, mred_lazy


def bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def bit_reverse_array(bits: int) -> np.ndarray:
    """[bit_reverse(j, bits) for j in range(2^bits)] as an int64 array."""
    idx = np.arange(1 << bits, dtype=np.int64)
    out = np.zeros_like(idx)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def _fwd_stage(x, w, q2, q, qinv, m: int, small: bool):
    shape = x.shape
    t = shape[-1] // (2 * m)
    xv = x.reshape(shape[:-1] + (m, 2, t))
    x0 = xv[..., 0, :]
    x1 = xv[..., 1, :]
    q2e = q2[..., None]
    x0 = torch.where(x0 >= q2e, x0 - q2e, x0)                       # [0, 2q)
    v = mred_lazy(x1, w, q[..., None], qinv[..., None], small)      # [0, 2q)
    return torch.stack([x0 + v, x0 - v + q2e], dim=-2).reshape(shape)


def _inv_stage(x, w, q2, q, qinv, m: int, small: bool):
    shape = x.shape
    t = shape[-1] // (2 * m)
    xv = x.reshape(shape[:-1] + (m, 2, t))
    x0 = xv[..., 0, :]
    x1 = xv[..., 1, :]
    q2e = q2[..., None]
    y0 = x0 + x1
    y0 = torch.where(y0 >= q2e, y0 - q2e, y0)                       # [0, 2q)
    y1 = mred_lazy(x0 - x1 + q2e, w, q[..., None], qinv[..., None], small)
    return torch.stack([y0, y1], dim=-2).reshape(shape)


def ntt(x, roots, q, qinv, logn: int, lazy: bool = False,
        small: bool | None = None):
    """Forward negacyclic NTT of int64[..., L, N] (inputs in [0, 2q)).

    roots: int64[L, N] bit-reversed Montgomery root powers; q, qinv:
    int64[L, 1]. Lazy output is in [0, 4q), else [0, q); bit-reversed order.
    """
    small = bool(int(q.max()) < (1 << 30)) if small is None else small
    q2 = q + q
    for s in range(logn):
        m = 1 << s
        x = _fwd_stage(x, roots[..., m:2 * m, None], q2, q, qinv, m, small)
    if lazy:
        return x
    x = torch.where(x >= q2, x - q2, x)
    return cred(x, q)


def intt(x, iroots, ninv_mont, q, qinv, logn: int, lazy: bool = False,
         small: bool | None = None):
    """Inverse negacyclic NTT; bit-reversed input, natural-order output.

    ninv_mont: int64[L, 1], N^{-1} in Montgomery form; the final Montgomery
    multiply scales by N^{-1}. Lazy output is in [0, 2q).
    """
    small = bool(int(q.max()) < (1 << 30)) if small is None else small
    q2 = q + q
    for s in range(logn - 1, -1, -1):
        m = 1 << s
        x = _inv_stage(x, iroots[..., m:2 * m, None], q2, q, qinv, m, small)
    if lazy:
        return mred_lazy(x, ninv_mont, q, qinv, small)
    return mred(x, ninv_mont, q, qinv, small)
