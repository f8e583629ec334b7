"""RNS rescaling: exact division by the last modulus (floor / round).

Counterpart of :mod:`lattigo_tpu.ring.scaling`. A poly at level l
(``[l+1, N]``) is divided by q_l and re-expressed at level l-1:

    floor:  out_i = (a_i - a_l) · q_l^{-1}          (mod q_i)
    round:  x' = x + ⌊q_l/2⌋, then floor-divide x'

In the NTT domain only the last limb goes back to coefficients (one
single-limb INTT at limb offset l); its lift into the other limbs is
transformed in one batched NTT.
"""

from __future__ import annotations

from lattigo_tpu_torch.ring import modops
from lattigo_tpu_torch.ring.ring import u64_tensor


def _lift_last_residue(ring, r, level: int, half: int | None):
    """Reduce last-limb residues r (int64[..., N] < q_level) mod
    q_0..q_{level-1}; with ``half``, subtract half mod q_i afterwards
    (centered rounding). Returns int64[..., level, N]."""
    q = ring.q[:level]
    lifted = modops.bred_add(r[..., None, :], q, ring.bred_hi[:level])
    if half is None:
        return lifted
    half_i = u64_tensor([half % m for m in ring.moduli[:level]], ring.device,
                        (level, 1))
    return modops.sub_mod(lifted, half_i, q)


def div_by_last_modulus(ring, a, level: int | None = None,
                        ntt_domain: bool = False, round_div: bool = True):
    """Divide by q_level and drop the last limb: [l+1, N] → [l, N]."""
    level = ring.max_level if level is None else level
    assert level >= 1, "cannot rescale below level 0"
    q_last = ring.moduli[level]
    body, last = a[..., :level, :], a[..., level, :]
    if ntt_domain:
        last = ring.intt_single(level, last[..., None, :])[..., 0, :]
    half = (q_last >> 1) if round_div else None
    if half is not None:
        last = modops.cred(last + half, q_last)
    lifted = _lift_last_residue(ring, last, level, half)
    if ntt_domain:
        lifted = ring.ntt(lifted, level=level - 1)
    diff = modops.sub_mod(body, lifted, ring.q[:level])
    return modops.mred(diff, ring.rescale_constants[level, :level],
                       ring.q[:level], ring.qinv[:level], ring.small)


def div_by_last_modulus_many(ring, a, k: int, level: int | None = None,
                             ntt_domain: bool = False, round_div: bool = True):
    """Drop the last k moduli by k exact divisions: [l+1, N] → [l+1-k, N]."""
    level = ring.max_level if level is None else level
    for j in range(k):
        a = div_by_last_modulus(ring, a, level - j, ntt_domain=ntt_domain,
                                round_div=round_div)
    return a
