"""Encryption ↔ secret-sharing conversion and collective refresh (CKKS and
any scheme with centred integer plaintexts).

Counterpart of :mod:`lattigo_tpu.multiparty.sharing`. EncToShare: each
party publishes h_i = e_i + s_i·c1 − M_i (decryption is pt = c0 + c1·s) and
keeps its mask M_i, so c0 + Σ h_i plus Σ M_i is the plaintext.
ShareToEnc: parties publish h'_i = e_i − s_i·crp + M_i; the aggregate is the
c0 of a fresh ciphertext with c1 = crp. Masks are uniform below a
statistical flooding bound 2^log_bound ≫ the noise.

One fault of the reference is not copied: where the masked transform
re-encrypts into another parameter set at a larger scale, the mask times
the scale ratio must stay an int64, so ``gen_share`` raises where
log_bound + log2(ratio) > 62 instead of wrapping.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from lattigo_tpu_torch.multiparty.protocols import noise_ntt
from lattigo_tpu_torch.ring import sampling
from lattigo_tpu_torch.ring.basis_extension import ModUpConstants, mod_up
from lattigo_tpu_torch.rlwe.elements import Ciphertext
from lattigo_tpu_torch.rlwe.keys import SecretKey
from lattigo_tpu_torch.rlwe.params import Parameters

#: the largest mask bit-length times scale ratio an int64 carries with
#: room for a sign and the transform's own rounding
MAX_SCALED_MASK_BITS = 62


def get_minimum_level_for_refresh(lambda_: int, scale, n_parties: int,
                                  moduli) -> tuple[int, int, bool]:
    """(min_level, log_bound, ok) for a refresh with ≥ ``lambda_`` bits of
    statistical security: masks flood the plaintext (≈ scale) by
    2^lambda_, and the modulus at the level holds n_parties of them;
    ok is False when the chain is too short."""
    log_bound = lambda_ + math.ceil(math.log2(float(scale)))
    max_bound = math.ceil(log_bound + math.log2(n_parties))
    min_level, log_q, i = -1, 0.0, 0
    while log_q < max_bound:
        if i >= len(moduli):
            return 0, 0, False
        log_q += math.log2(moduli[i])
        min_level += 1
        i += 1
    return min_level, log_bound, True


def _sample_mask_signed(gen: torch.Generator, n: int, log_bound: int,
                        batch: tuple[int, ...] = ()):
    """Uniform signed mask int64[*batch, N] in [−2^b, 2^b), b ≤ 62."""
    if log_bound > 62:
        raise ValueError(f"mask bound 2^{log_bound} does not fit an int64")
    return torch.randint(-(1 << log_bound), 1 << log_bound, batch + (n,),
                         generator=gen, device=gen.device)


class EncToShareProtocol:
    def __init__(self, params: Parameters, log_bound: int = 40,
                 noise_sigma: float = 3.2):
        self.params = params
        self.log_bound = log_bound
        self.noise_sigma = noise_sigma

    def gen_share(self, gen: torch.Generator, sk: SecretKey, ct: Ciphertext):
        """→ (secret mask int64[N], public share int64[l+1, N], NTT)."""
        p = self.params
        rq = p.ring_q
        level = ct.level
        batch = tuple(ct.value.shape[:-3])
        mask = _sample_mask_signed(gen, p.n, self.log_bound, batch)
        mask_q = rq.ntt(sampling.lift_signed(rq, mask, level), level)
        c1s = rq.mul_mont(ct.value[..., 1, :, :],
                          sk.value.q[..., : level + 1, :], level)
        e = noise_ntt(gen, p, self.noise_sigma, level, batch)
        return mask, rq.sub(rq.add(e, c1s, level), mask_q, level)

    def aggregate_shares(self, h1, h2):
        # the level travels in the limb axis
        return self.params.ring_q.add(h1, h2, h1.shape[-2] - 1)

    def finalize_public(self, ct: Ciphertext, h_agg):
        """c0 + Σ h_i: with Σ M_i added, the plaintext."""
        return self.params.ring_q.add(ct.value[..., 0, :, :], h_agg, ct.level)


class ShareToEncProtocol:
    def __init__(self, params: Parameters, noise_sigma: float = 3.2):
        self.params = params
        self.noise_sigma = noise_sigma

    def sample_crp(self, seed: bytes, level: int | None = None):
        """The c1 of the new ciphertext: uniform, NTT domain."""
        rq = self.params.ring_q
        return rq.ntt(sampling.KeyedPRNG(seed).uniform_poly(rq, level), level)

    def gen_share(self, gen: torch.Generator, sk: SecretKey, mask, crp,
                  level: int | None = None):
        """h'_i = e_i − s_i·crp + M_i (NTT domain)."""
        p = self.params
        rq = p.ring_q
        level = p.max_level if level is None else level
        mask = torch.as_tensor(mask)
        mask_q = rq.ntt(sampling.lift_signed(rq, mask, level), level)
        cs = rq.mul_mont(crp, sk.value.q[..., : level + 1, :], level)
        e = noise_ntt(gen, p, self.noise_sigma, level, tuple(mask.shape[:-1]))
        return rq.add(rq.sub(e, cs, level), mask_q, level)

    def aggregate_shares(self, s1, s2):
        return self.params.ring_q.add(s1, s2, s1.shape[-2] - 1)

    def finalize(self, agg, crp, extra_c0=None, scale=1.0,
                 level: int | None = None) -> Ciphertext:
        """(Σ h'_i [+ extra_c0], crp)."""
        p = self.params
        level = p.max_level if level is None else level
        c0 = agg if extra_c0 is None else p.ring_q.add(agg, extra_c0, level)
        return Ciphertext(value=torch.stack([c0, crp.expand(c0.shape)], dim=-3),
                          is_ntt=True, scale=scale)


class MaskedTransformProtocol:
    """Refresh with a public linear transform applied inside the masking.

    One round: each party publishes its E2S share and an S2E share of its
    transformed mask; the aggregator applies the transform to the public
    masked plaintext. The transform is linear, so it commutes with the
    sharing: T(pt) = T(pt − Σ M) + Σ T(M_i).

    ``transform`` maps centred integer coefficient vectors (int64[N]) to
    integer vectors on the host (:func:`ckks_coeff_transform` builds one
    from a slot-space function). ``params_out`` (or :meth:`with_params`)
    re-encrypts into another parameter set of the same N: the value is
    multiplied by scale_out / scale_in inside the integer mask arithmetic,
    so the output reads the same message at the output's default scale.
    Takes one ciphertext.
    """

    def __init__(self, params: Parameters, log_bound: int = 40,
                 params_out: Parameters | None = None, scale_ratio=None):
        self.params = params
        self.params_out = params if params_out is None else params_out
        if self.params_out.n != params.n:
            raise ValueError("masked transform requires matching ring degree")
        self.log_bound = log_bound
        self.e2s = EncToShareProtocol(params, log_bound)
        self.s2e = ShareToEncProtocol(self.params_out)
        self.scale_ratio = scale_ratio

    def with_params(self, params_out: Parameters,
                    scale_ratio=None) -> "MaskedTransformProtocol":
        """A copy that re-encrypts into ``params_out``; the input
        parameters are unchanged."""
        return MaskedTransformProtocol(self.params, self.log_bound,
                                       params_out=params_out,
                                       scale_ratio=scale_ratio)

    def _ratio(self, scale_in) -> Fraction:
        if self.scale_ratio is not None:
            return Fraction(self.scale_ratio)
        if self.params_out is self.params:
            return Fraction(1)
        return (Fraction(self.params_out.default_scale_fraction)
                / Fraction(scale_in))

    @staticmethod
    def _apply(transform, coeffs, ratio: Fraction):
        out = transform(coeffs)
        if ratio == 1:
            return out
        num, den = ratio.numerator, ratio.denominator
        return np.array([(2 * int(x) * num + den) // (2 * den) for x in out],
                        dtype=object)

    def sample_crp(self, seed: bytes, level: int | None = None):
        return self.s2e.sample_crp(seed, level)

    def gen_share(self, gen: torch.Generator, sk: SecretKey, ct: Ciphertext,
                  crp, transform, level_out: int | None = None,
                  sk_out: SecretKey | None = None):
        """→ (h_e2s at the ct's level, h_s2e at ``level_out``).

        ``sk_out``: the party's secret in the output parameter set (the same
        coefficients, :meth:`KeyGenerator.secret_key_from_signed`);
        defaults to ``sk``."""
        ratio = self._ratio(ct.scale)
        if ratio > 1 and self.log_bound + math.log2(ratio) > MAX_SCALED_MASK_BITS:
            raise ValueError(
                f"a 2^{self.log_bound} mask times the scale ratio 2^"
                f"{math.log2(ratio):.2f} does not fit "
                f"{MAX_SCALED_MASK_BITS} bits: lower log_bound")
        po = self.params_out
        level_out = po.max_level if level_out is None else level_out
        mask, h = self.e2s.gen_share(gen, sk, ct)
        tmask = self._apply(transform, mask.cpu().numpy(), ratio)
        tmask = np.asarray([int(x) for x in tmask], dtype=np.int64)
        h2 = self.s2e.gen_share(gen, sk if sk_out is None else sk_out,
                                torch.from_numpy(tmask), crp, level_out)
        return h, h2

    def aggregate_shares(self, s1, s2):
        return (self.params.ring_q.add(s1[0], s2[0], s1[0].shape[-2] - 1),
                self.params_out.ring_q.add(s1[1], s2[1], s1[1].shape[-2] - 1))

    def finalize(self, ct: Ciphertext, agg, crp, transform,
                 level_out: int | None = None) -> Ciphertext:
        """Transform the public masked plaintext (host integers), lift it
        into the output chain, add it to the S2E aggregate."""
        p, po = self.params, self.params_out
        level_in = ct.level
        level_out = po.max_level if level_out is None else level_out
        ratio = self._ratio(ct.scale)
        pub = self.e2s.finalize_public(ct, agg[0])
        coeffs = p.ring_q.to_int_coeffs(p.ring_q.intt(pub, level_in), level_in,
                                        centered=True)
        tpub = self._apply(transform, np.array(coeffs, dtype=object), ratio)
        lifted = po.ring_q.ntt(po.ring_q.from_int_coeffs(list(tpub), level_out),
                               level_out)
        return self.s2e.finalize(agg[1], crp, extra_c0=lifted,
                                 scale=Fraction(ct.scale) * ratio, level=level_out)


def ckks_coeff_transform(encoder, fn):
    """Lift a linear slot-space function C^{N/2} → C^{N/2} to a centred
    integer coefficient transform (host; rounds to the nearest integer)."""
    def transform(coeffs):
        slots = encoder.coeffs_to_slots(np.asarray(coeffs, dtype=np.float64))
        back = encoder.embed_to_coeffs(fn(slots))
        return np.array([int(round(float(np.real(x)))) for x in back], dtype=object)
    return transform


class RefreshProtocol:
    """Collective bootstrap: E2S at the input level, S2E at a higher one.

    The public value c0 + Σ h is added on the S2E side after a centred,
    exact lift from Q_in to Q_out (:meth:`lift_public`: masks and message
    are far below Q_in / 2)."""

    def __init__(self, params: Parameters, log_bound: int = 40):
        self.params = params
        self.e2s = EncToShareProtocol(params, log_bound)
        self.s2e = ShareToEncProtocol(params)
        self._lift: dict[tuple[int, int], ModUpConstants] = {}

    def lift_public(self, combined, level_in: int, level_out: int):
        """Centred basis lift Q_in → Q_out of the public masked plaintext
        (NTT domain in and out)."""
        p = self.params
        rq = p.ring_q
        consts = self._lift.get((level_in, level_out))
        if consts is None:
            consts = self._lift[(level_in, level_out)] = ModUpConstants(
                p.q_moduli[: level_in + 1], p.q_moduli[: level_out + 1], p.device)
        l = level_out + 1
        out = mod_up(rq.intt(combined, level_in), consts, rq.q[:l],
                     rq.qinv[:l], rq.bred_hi[:l], centered=True)
        return rq.ntt(out, level_out)
