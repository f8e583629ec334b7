"""Multiparty (threshold) HE protocols: collective key generation and key
switching.

Counterpart of :mod:`lattigo_tpu.multiparty.protocols`. Every protocol
follows the share pattern: sample the common reference polynomials (CRPs)
from a seed every party shares → ``gen_share`` (local, uses the party's
secret and its own ``torch.Generator``) → ``aggregate_shares`` (ring
addition, associative, so any reduction tree works) → ``finalize``.
Shares are plain tensors, :class:`QPPoly` pairs and lists of them;
carrying them between parties is the application's job.

CRPs come from the :class:`~lattigo_tpu_torch.ring.sampling.KeyedPRNG`: NTT
domain, not Montgomery; ``finalize`` puts them in M-form where a key row
needs it. Where the input is a batch of ciphertexts (leading axes), the
per-ciphertext draws of CKS and PCKS carry those axes, so no two
ciphertexts of a batch share their flooding noise.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lattigo_tpu_torch.ring import modops, sampling
from lattigo_tpu_torch.ring.ringqp import QPPoly, stack as qp_stack
from lattigo_tpu_torch.rlwe.elements import Ciphertext
from lattigo_tpu_torch.rlwe.keys import (
    EvaluationKey, GadgetCiphertext, GaloisKey, KeyGenerator, PublicKey,
    RelinearizationKey, SecretKey, keyed_uniform_qp,
)
from lattigo_tpu_torch.rlwe.params import Parameters


def sample_crp_qp(params: Parameters, seed: bytes, count: int = 1) -> list[QPPoly]:
    """``count`` uniform R_QP polynomials (NTT domain) from a shared seed."""
    return keyed_uniform_qp(params, seed, count)


def _num_digits(params: Parameters) -> int:
    return -(-(params.max_level + 1) // len(params.p_moduli))


def noise_ntt(gen: torch.Generator, params: Parameters, sigma: float,
              level: int, batch: tuple[int, ...] = ()):
    """NTT of a rounded Gaussian of width sigma (bound 6σ), int64[*batch, l+1, N]."""
    rq = params.ring_q
    e = sampling.gaussian_signed(
        gen, params.n, sampling.DiscreteGaussian(sigma, 6 * sigma), batch)
    return rq.ntt(sampling.lift_signed(rq, e, level), level)


# ---------------------------------------------------------------------------
# Collective public key
# ---------------------------------------------------------------------------

class PublicKeyGenProtocol:
    """One round: share_i = e_i − s_i·crp over R_QP."""

    def __init__(self, params: Parameters):
        self.params = params

    def sample_crp(self, seed: bytes) -> QPPoly:
        return sample_crp_qp(self.params, seed)[0]

    def gen_share(self, gen: torch.Generator, sk: SecretKey, crp: QPPoly) -> QPPoly:
        p = self.params
        rqp = p.ring_qp
        e = rqp.ntt(rqp.sample_signed(gen, p.xe))
        return rqp.sub(e, rqp.mul_mont(crp, sk.value))

    def aggregate_shares(self, s1: QPPoly, s2: QPPoly) -> QPPoly:
        return self.params.ring_qp.add(s1, s2)

    def finalize(self, agg: QPPoly, crp: QPPoly) -> PublicKey:
        rqp = self.params.ring_qp
        return PublicKey(qp_stack([rqp.mform(agg), rqp.mform(crp)]))


# ---------------------------------------------------------------------------
# Collective key switching
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NoiseFlooding:
    """Smudging noise σ of CKS / PCKS shares."""

    sigma: float = 3.2


class KeySwitchProtocol:
    """CKS: ct under Σ s_in,i → ct under Σ s_out,i (s_out = 0 decrypts)."""

    def __init__(self, params: Parameters, noise: NoiseFlooding = NoiseFlooding()):
        self.params = params
        self.noise = noise

    def gen_share(self, gen: torch.Generator, sk_in: SecretKey,
                  sk_out: SecretKey | None, ct: Ciphertext):
        """share = c1·(s_in − s_out) + e, NTT domain, at the ct's level."""
        p = self.params
        if not ct.is_ntt:
            raise ValueError("CKS takes an NTT-domain ciphertext")
        level = ct.level
        l = level + 1
        s_in = sk_in.value.q[..., :l, :]
        s_out = (torch.zeros_like(s_in) if sk_out is None
                 else sk_out.value.q[..., :l, :])
        delta = modops.sub_mod(s_in, s_out, p.ring_q.q[:l])     # still M-form
        h = p.ring_q.mul_mont(ct.value[..., 1, :, :], delta, level)
        e = noise_ntt(gen, p, self.noise.sigma, level, tuple(ct.value.shape[:-3]))
        return p.ring_q.add(h, e, level)

    def aggregate_shares(self, s1, s2):
        # the level travels in the limb axis: never broadcast a level-l
        # share against the full chain's tables
        return self.params.ring_q.add(s1, s2, s1.shape[-2] - 1)

    def key_switch(self, ct: Ciphertext, combined) -> Ciphertext:
        """(c0 + Σ share, c1)."""
        value = ct.value.clone()
        value[..., 0, :, :] = self.params.ring_q.add(
            ct.value[..., 0, :, :], combined, ct.level)
        return ct.replace(value=value)


class PublicKeySwitchProtocol:
    """PCKS: re-encrypt from Σ s_i to a foreign public key."""

    def __init__(self, params: Parameters, noise: NoiseFlooding = NoiseFlooding()):
        self.params = params
        self.noise = noise

    def gen_share(self, gen: torch.Generator, sk: SecretKey, pk_out: PublicKey,
                  ct: Ciphertext):
        """share = (u·pk0 + s·c1 + e0, u·pk1 + e1) over Q, u ternary."""
        p = self.params
        rq = p.ring_q
        level = ct.level
        l = level + 1
        batch = tuple(ct.value.shape[:-3])
        u = rq.ntt(sampling.lift_signed(
            rq, sampling.signed(gen, p.n, p.xs, batch), level), level)
        h0 = rq.mul_mont(u, pk_out.value.q[0, :l, :], level)
        h1 = rq.mul_mont(u, pk_out.value.q[1, :l, :], level)
        h0 = rq.add(h0, rq.mul_mont(ct.value[..., 1, :, :],
                                    sk.value.q[..., :l, :], level), level)
        e0 = noise_ntt(gen, p, self.noise.sigma, level, batch)
        e1 = noise_ntt(gen, p, self.noise.sigma, level, batch)
        return rq.add(h0, e0, level), rq.add(h1, e1, level)

    def aggregate_shares(self, s1, s2):
        rq = self.params.ring_q
        level = s1[0].shape[-2] - 1
        return rq.add(s1[0], s2[0], level), rq.add(s1[1], s2[1], level)

    def key_switch(self, ct: Ciphertext, combined) -> Ciphertext:
        """(c0 + Σ h0, Σ h1)."""
        h0, h1 = combined
        c0 = self.params.ring_q.add(ct.value[..., 0, :, :], h0, ct.level)
        return ct.replace(value=torch.stack([c0, h1], dim=-3))


# ---------------------------------------------------------------------------
# Collective evaluation keys
# ---------------------------------------------------------------------------

class GaloisKeyGenProtocol:
    """One round, per gadget digit d: share_d = mform(e − crp_d·σ⁻¹(s_i))
    + s_i·g_d, the single-party Galois key with the CRPs as its c1 rows."""

    def __init__(self, params: Parameters):
        self.params = params
        self.kgen = KeyGenerator(params)

    def num_digits(self) -> int:
        return _num_digits(self.params)

    def sample_crp(self, seed: bytes) -> list[QPPoly]:
        return sample_crp_qp(self.params, seed, self.num_digits())

    def gen_share(self, gen: torch.Generator, gal_el: int, sk: SecretKey,
                  crps: list[QPPoly]) -> list[QPPoly]:
        p = self.params
        rqp = p.ring_qp
        s_inv = rqp.automorphism_ntt(sk.value, p.galois_element_inverse(gal_el))
        gfac = self.kgen._gadget_scalars(p.max_level)
        shares = []
        for d, crp in enumerate(crps):
            e = rqp.ntt(rqp.sample_signed(gen, p.xe))
            c0 = rqp.mform(rqp.sub(e, rqp.mul_mont(crp, s_inv)))
            shares.append(self.kgen._add_gadget_term(c0, sk.value.q, d, gfac))
        return shares

    def aggregate_shares(self, s1, s2):
        rqp = self.params.ring_qp
        return [rqp.add(a, b) for a, b in zip(s1, s2)]

    def finalize(self, gal_el: int, agg, crps: list[QPPoly]) -> GaloisKey:
        rqp = self.params.ring_qp
        rows = [qp_stack([c0, rqp.mform(crp)]) for c0, crp in zip(agg, crps)]
        return GaloisKey(GadgetCiphertext(qp_stack(rows)), gal_el)


class EvaluationKeyGenProtocol:
    """One round, generic key sk_in → sk_out: each party holds additive
    shares of both secrets; share_d = mform(e − crp_d·s_out,i) + s_in,i·g_d."""

    def __init__(self, params: Parameters):
        self.params = params
        self.kgen = KeyGenerator(params)

    def num_digits(self) -> int:
        return _num_digits(self.params)

    def sample_crp(self, seed: bytes) -> list[QPPoly]:
        return sample_crp_qp(self.params, seed, self.num_digits())

    def gen_share(self, gen: torch.Generator, sk_in: SecretKey,
                  sk_out: SecretKey, crps: list[QPPoly]) -> list[QPPoly]:
        p = self.params
        rqp = p.ring_qp
        gfac = self.kgen._gadget_scalars(p.max_level)
        shares = []
        for d, crp in enumerate(crps):
            e = rqp.ntt(rqp.sample_signed(gen, p.xe))
            c0 = rqp.mform(rqp.sub(e, rqp.mul_mont(crp, sk_out.value)))
            shares.append(self.kgen._add_gadget_term(c0, sk_in.value.q, d, gfac))
        return shares

    def aggregate_shares(self, s1, s2):
        rqp = self.params.ring_qp
        return [rqp.add(a, b) for a, b in zip(s1, s2)]

    def finalize(self, agg, crps: list[QPPoly]) -> EvaluationKey:
        rqp = self.params.ring_qp
        rows = [qp_stack([c0, rqp.mform(crp)]) for c0, crp in zip(agg, crps)]
        return EvaluationKey(GadgetCiphertext(qp_stack(rows)))


class RelinearizationKeyGenProtocol:
    """Two rounds with an ephemeral secret u_i per party.

    Round 1, per digit: h0_i = −u_i·crp + s_i·g + e0_i, h1_i = s_i·crp + e1_i.
    Round 2, on the aggregates (h0, h1): g0_i = s_i·h0 + e2_i,
    g1_i = (u_i − s_i)·h1 + e3_i. Key row d: (Σg0 + Σg1, h1).
    """

    def __init__(self, params: Parameters):
        self.params = params
        self.kgen = KeyGenerator(params)

    def num_digits(self) -> int:
        return _num_digits(self.params)

    def sample_crp(self, seed: bytes) -> list[QPPoly]:
        return sample_crp_qp(self.params, seed, self.num_digits())

    def gen_ephemeral(self, gen: torch.Generator) -> SecretKey:
        p = self.params
        return SecretKey(p.ring_qp.mform(p.ring_qp.ntt(
            p.ring_qp.sample_signed(gen, p.xs))))

    def _noise_m(self, gen: torch.Generator) -> QPPoly:
        rqp = self.params.ring_qp
        return rqp.mform(rqp.ntt(rqp.sample_signed(gen, self.params.xe)))

    def gen_share_round1(self, gen: torch.Generator, sk: SecretKey,
                         u: SecretKey, crps: list[QPPoly]):
        p = self.params
        rqp = p.ring_qp
        gfac = self.kgen._gadget_scalars(p.max_level)
        shares = []
        for d, crp in enumerate(crps):
            e0 = self._noise_m(gen)
            e1 = self._noise_m(gen)
            crp_m = rqp.mform(crp)
            h0 = rqp.add(rqp.neg(rqp.mul_mont(crp_m, u.value)), e0)
            h0 = self.kgen._add_gadget_term(h0, sk.value.q, d, gfac)
            h1 = rqp.add(rqp.mul_mont(crp_m, sk.value), e1)
            shares.append((h0, h1))
        return shares

    def aggregate_shares(self, s1, s2):
        rqp = self.params.ring_qp
        return [(rqp.add(a0, b0), rqp.add(a1, b1))
                for (a0, a1), (b0, b1) in zip(s1, s2)]

    def gen_share_round2(self, gen: torch.Generator, sk: SecretKey,
                         u: SecretKey, agg1):
        rqp = self.params.ring_qp
        u_minus_s = rqp.sub(u.value, sk.value)
        shares = []
        for h0, h1 in agg1:
            e2 = self._noise_m(gen)
            e3 = self._noise_m(gen)
            shares.append((rqp.add(rqp.mul_mont(h0, sk.value), e2),
                           rqp.add(rqp.mul_mont(h1, u_minus_s), e3)))
        return shares

    def finalize(self, agg1, agg2) -> RelinearizationKey:
        """Row d = (g0 + g1, h1): d0 + d1·s = s²·g + noise."""
        rqp = self.params.ring_qp
        rows = [qp_stack([rqp.add(g0, g1), h1])
                for (_h0, h1), (g0, g1) in zip(agg1, agg2)]
        return RelinearizationKey(GadgetCiphertext(qp_stack(rows)))
