"""Coefficient-axis ("sequence-parallel") sharded NTT over a mesh axis.

Counterpart of :mod:`lattigo_tpu.parallel.ntt_sp`. Each rank of the axis
group holds N/D contiguous coefficients of every polynomial. Cooley–Tukey
stage s pairs coefficients at distance N/2^{s+1}, so the FIRST log2(D)
forward stages cross ranks: each is one pairwise chunk swap with the
partner d ⊕ D/2^{s+1} (:meth:`Mesh.exchange`, the counterpart of
``lax.ppermute``), then a Harvey butterfly against the rank's scalar
twiddle. The remaining stages run on the rank's slice of the same
bit-reversed root tables through the port's stage loop
(:mod:`lattigo_tpu_torch.ring.ntt`), so every coefficient sees the same
expression tree as in the one-process radix-2 NTT, lazy outputs included.
The inverse runs the mirror schedule and ends in the N^{-1} Montgomery
multiply. The local stages are plain torch here as they are XLA on a TPU.
"""

from __future__ import annotations

import torch

from lattigo_tpu_torch.ring import modops
from lattigo_tpu_torch.ring.modops import cred, mred, mred_lazy
from lattigo_tpu_torch.ring.ntt import _fwd_stage, _inv_stage


def _axis(ring, x, mesh, axis: str):
    n_dev = mesh.shape[axis]
    log_d = n_dev.bit_length() - 1
    assert 1 << log_d == n_dev and n_dev <= ring.n
    if x.shape[-1] * n_dev != ring.n:
        raise ValueError(f"a rank holds {x.shape[-1]} coefficients, not "
                         f"N/D = {ring.n // n_dev}")
    l = x.shape[-2]
    return n_dev, log_d, mesh.coords[axis], ring.q[:l], ring.qinv[:l], l


def shard_coefficients(x, mesh, axis: str):
    """This rank's N/D contiguous coefficients of x [..., N]."""
    k = x.shape[-1] // mesh.shape[axis]
    return x[..., mesh.coords[axis] * k:(mesh.coords[axis] + 1) * k].contiguous()


def gather_coefficients(x, mesh, axis: str):
    """The whole coefficient axis, on every rank of the group."""
    return mesh.all_gather(x, axis, dim=-1)


def ntt_sharded(ring, x, mesh, axis: str, lazy: bool = False):
    """Forward negacyclic NTT of x int64[..., L, N/D], the coefficient axis
    sharded over ``axis``. Bit-exact vs the one-process radix-2 NTT (lazy
    output in [0, 4q), else [0, q))."""
    n_dev, log_d, d, q, qinv, l = _axis(ring, x, mesh, axis)
    roots, small = ring.roots[:l], ring.small
    q2 = q + q
    for s in range(log_d):                  # cross-rank stages
        dist = n_dev >> (s + 1)
        other = mesh.exchange(x, axis, d ^ dist)
        m = 1 << s
        g = d >> (log_d - s)                # group index of this chunk
        w = roots[:, m + g:m + g + 1]
        is_hi = (d & dist) != 0             # this chunk is the x1 half
        x0, x1 = (other, x) if is_hi else (x, other)
        x0 = torch.where(x0 >= q2, x0 - q2, x0)
        v = mred_lazy(x1, w, q, qinv, small)
        x = x0 - v + q2 if is_hi else x0 + v
    for s in range(log_d, ring.log_n):      # local stages
        m = 1 << s
        m_loc = m >> log_d
        off = m + d * m_loc
        x = _fwd_stage(x, roots[:, off:off + m_loc, None], q2, q, qinv, m_loc, small)
    if lazy:
        return x
    x = torch.where(x >= q2, x - q2, x)
    return cred(x, q)


def intt_sharded(ring, x, mesh, axis: str, level: int | None = None,
                 lazy: bool = False):
    """Inverse negacyclic NTT (mirror schedule). Bit-exact vs the
    one-process radix-2 INTT. ``level`` is ignored, as in the JAX package
    (the limbs are x's)."""
    del level
    n_dev, log_d, d, q, qinv, l = _axis(ring, x, mesh, axis)
    iroots, small = ring.iroots[:l], ring.small
    q2 = q + q
    for s in range(ring.log_n - 1, log_d - 1, -1):   # local stages
        m = 1 << s
        m_loc = m >> log_d
        off = m + d * m_loc
        x = _inv_stage(x, iroots[:, off:off + m_loc, None], q2, q, qinv, m_loc, small)
    for s in range(log_d - 1, -1, -1):               # cross-rank stages
        dist = n_dev >> (s + 1)
        other = mesh.exchange(x, axis, d ^ dist)
        m = 1 << s
        g = d >> (log_d - s)
        w = iroots[:, m + g:m + g + 1]
        is_hi = (d & dist) != 0
        x0, x1 = (other, x) if is_hi else (x, other)
        if is_hi:
            x = mred_lazy(x0 - x1 + q2, w, q, qinv, small)
        else:
            y0 = x0 + x1
            x = torch.where(y0 >= q2, y0 - q2, y0)
    ninv = ring.ninv[:l]
    if lazy:
        return mred_lazy(x, ninv, q, qinv, small)
    return mred(x, ninv, q, qinv, small)


def negacyclic_mul_sharded(ring, a, b, mesh, axis: str):
    """a·b mod X^N + 1 with the coefficient axis sharded end to end:
    NTT(a)·NTT(b) (the product is rank-local), then the INTT."""
    fa = ntt_sharded(ring, a, mesh, axis)
    fb = ntt_sharded(ring, b, mesh, axis)
    l = a.shape[-2]
    q, qinv = ring.q[:l], ring.qinv[:l]
    prod = mred(modops.mform(fa, q, ring.bred_hi[:l], ring.bred_lo[:l]), fb,
                q, qinv, ring.small)
    return intt_sharded(ring, prod, mesh, axis)
