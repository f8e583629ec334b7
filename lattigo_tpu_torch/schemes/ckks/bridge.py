"""DomainSwitcher: standard ↔ conjugate-invariant CKKS.

Counterpart of :mod:`lattigo_tpu.schemes.ckks.bridge` (the reference's
``schemes/ckks/bridge.go`` and the ring-swap keys of
``core/rlwe/keygenerator.go``). The standard ring has degree 2N and the CI
ring degree N over the SAME modulus chain (both cyclotomics have NthRoot =
4N, so one prime set serves both):

* complex_to_real: key-switch the standard ciphertext to the unfolded image
  of the CI secret, then fold x ↦ x + σ_{4N−1}(x) and keep the first N NTT
  values: enc(Re(m)) at twice the scale;
* real_to_complex: unfold the CI ciphertext's NTT values palindromically
  into the 2N ring (CI values are symmetric under conjugation), then
  key-switch back to the standard secret: enc(r + 0i).

Slots correspond index for index: both rings order them along the 5-orbit
of the 4N-th roots.
"""

from __future__ import annotations

from fractions import Fraction

import torch

from lattigo_tpu_torch.ring import automorphism as auto_mod
from lattigo_tpu_torch.ring.ringqp import QPPoly
from lattigo_tpu_torch.rlwe.elements import Ciphertext
from lattigo_tpu_torch.rlwe.evaluator import Evaluator as RlweEvaluator
from lattigo_tpu_torch.rlwe.keys import EvaluationKey, KeyGenerator, SecretKey


def _unfold_values(x):
    """Palindromic NTT-value extension [..., N] → [..., 2N]:
    std[2N−1−j] = ci[j] (conjugate positions carry equal CI values)."""
    return torch.cat([x, torch.flip(x, dims=(-1,))], dim=-1)


def unfold_secret(params_std, sk_ci: SecretKey) -> SecretKey:
    """A CI secret's image in the standard 2N ring (NTT + Montgomery
    values, as the secret is kept)."""
    q = _unfold_values(sk_ci.value.q)
    p = None if sk_ci.value.p is None else _unfold_values(sk_ci.value.p)
    return SecretKey(QPPoly(q, p))


def gen_ring_swap_keys(gen: torch.Generator, params_std, sk_std: SecretKey,
                       sk_ci: SecretKey) -> tuple[EvaluationKey, EvaluationKey]:
    """(std→ci, ci→std) evaluation keys, both in the standard 2N ring,
    drawn from ``gen`` in that order."""
    kgen = KeyGenerator(params_std)
    sk_map = unfold_secret(params_std, sk_ci)
    return (kgen.gen_evaluation_key(gen, sk_std, sk_map),
            kgen.gen_evaluation_key(gen, sk_map, sk_std))


class DomainSwitcher:
    """Switches CKKS ciphertexts between a standard ring of degree 2N and a
    conjugate-invariant ring of degree N on the same chain."""

    def __init__(self, params_std, params_ci, std_to_ci: EvaluationKey,
                 ci_to_std: EvaluationKey):
        if params_std.n != 2 * params_ci.n:
            raise ValueError("the standard ring must have twice the CI ring's degree")
        if params_std.q_moduli != params_ci.q_moduli:
            raise ValueError("the two rings must share one modulus chain")
        self.params_std = params_std
        self.params_ci = params_ci
        self.std_to_ci = std_to_ci
        self.ci_to_std = ci_to_std
        self.ev = RlweEvaluator(params_std)

    def complex_to_real(self, ct: Ciphertext) -> Ciphertext:
        """Standard enc(m) → CI enc(Re(m)) at twice the scale."""
        p = self.params_std
        level = ct.level
        if ct.degree != 1 or not ct.is_ntt:
            raise ValueError("complex_to_real takes a degree-1 NTT ciphertext")
        d = self.ev.gadget_product(ct.value[..., 1, :, :], self.std_to_ci.gadget, level)
        c0 = p.ring_q.add(d[..., 0, :, :], ct.value[..., 0, :, :], level)
        c1 = d[..., 1, :, :]
        # fold: x + σ_{4N−1}(x), keep the first N values
        idx = auto_mod.ntt_index(p.n, p.nth_root - 1, c0.device)
        n_ci = self.params_ci.n
        f0 = p.ring_q.add(c0, auto_mod.apply_ntt(c0, idx), level)[..., :n_ci]
        f1 = p.ring_q.add(c1, auto_mod.apply_ntt(c1, idx), level)[..., :n_ci]
        return Ciphertext(value=torch.stack([f0, f1], dim=-3), is_ntt=True,
                          scale=Fraction(ct.scale) * 2)

    def real_to_complex(self, ct: Ciphertext) -> Ciphertext:
        """CI enc(r) → standard enc(r + 0i) at the same scale."""
        p = self.params_std
        level = ct.level
        if ct.degree != 1 or not ct.is_ntt:
            raise ValueError("real_to_complex takes a degree-1 NTT ciphertext")
        u0 = _unfold_values(ct.value[..., 0, :, :])
        u1 = _unfold_values(ct.value[..., 1, :, :])
        d = self.ev.gadget_product(u1, self.ci_to_std.gadget, level)
        c0 = p.ring_q.add(u0, d[..., 0, :, :], level)
        return Ciphertext(value=torch.stack([c0, d[..., 1, :, :]], dim=-3),
                          is_ntt=True, scale=ct.scale)
