"""BGV/BFV encryption ↔ secret-sharing conversion and collective refresh.

Counterpart of :mod:`lattigo_tpu.multiparty.sharing_bgv`. Masks live in
R_T, uniform mod the plaintext modulus (no flooding bound needed), and the
R_T ↔ R_Q lifts are the BGV encoder's MSB encoding (×T^{-1} mod Q).
Transforms are user functions over Z_T vectors; their ``decode`` /
``encode`` flags wrap them in the slot transform at the ciphertext's scale.
Each protocol takes one ciphertext (a batch of them gets a mask per
ciphertext).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from lattigo_tpu_torch.multiparty.protocols import noise_ntt
from lattigo_tpu_torch.ring import sampling
from lattigo_tpu_torch.ring.ring import u64_tensor
from lattigo_tpu_torch.rlwe.elements import Ciphertext
from lattigo_tpu_torch.rlwe.keys import SecretKey
from lattigo_tpu_torch.schemes.bgv.encoder import Encoder
from lattigo_tpu_torch.schemes.bgv.params import Parameters


def _sample_mask_t(gen: torch.Generator, params: Parameters,
                   batch: tuple[int, ...] = ()):
    """Uniform mask in R_T: int64[*batch, 1, N] coefficients in [0, T)."""
    return torch.randint(0, params.t, batch + (1, params.n), generator=gen,
                         device=gen.device).to(params.device)


class BGVEncToShareProtocol:
    def __init__(self, params: Parameters, noise_sigma: float = 3.2):
        self.params = params
        self.encoder = Encoder(params)
        self.noise_sigma = noise_sigma

    def gen_share(self, gen: torch.Generator, sk: SecretKey, ct: Ciphertext):
        """→ (secret mask M_i int64[1, N] in R_T, public share
        h_i = e_i + s_i·c1 − Enc_Q(M_i), NTT, at the ct's level)."""
        p = self.params
        level = ct.level
        batch = tuple(ct.value.shape[:-3])
        mask_t = _sample_mask_t(gen, p, batch)
        mask_q = p.ring_q.ntt(self.encoder.ring_t_to_q(mask_t, level), level)
        c1s = p.ring_q.mul_mont(ct.value[..., 1, :, :],
                                sk.value.q[..., : level + 1, :], level)
        e = noise_ntt(gen, p, self.noise_sigma, level, batch)
        h = p.ring_q.sub(p.ring_q.add(e, c1s, level), mask_q, level)
        return mask_t, h

    def aggregate_shares(self, h1, h2):
        return self.params.ring_q.add(h1, h2, h1.shape[-2] - 1)

    def get_share(self, secret_mask, h_agg, ct: Ciphertext):
        """Masked decryption in R_T, m − Σ M_i; with the caller's own mask
        added it is the caller's additive share."""
        p = self.params
        level = ct.level
        pub = p.ring_q.add(ct.value[..., 0, :, :], h_agg, level)
        m_t = self.encoder.ring_q_to_t(p.ring_q.intt(pub, level), level)
        if secret_mask is not None:
            m_t = p.ring_t.add(m_t, secret_mask)
        return m_t


class BGVShareToEncProtocol:
    def __init__(self, params: Parameters, noise_sigma: float = 3.2):
        self.params = params
        self.encoder = Encoder(params)
        self.noise_sigma = noise_sigma

    def sample_crp(self, seed: bytes, level: int | None = None):
        """The c1 of the new ciphertext: uniform, NTT domain."""
        rq = self.params.ring_q
        return rq.ntt(sampling.KeyedPRNG(seed).uniform_poly(rq, level), level)

    def gen_share(self, gen: torch.Generator, sk: SecretKey, mask_t, crp,
                  level: int | None = None):
        """h'_i = e_i − s_i·crp + Enc_Q(M_i)."""
        p = self.params
        level = p.max_level if level is None else level
        mask_q = p.ring_q.ntt(self.encoder.ring_t_to_q(mask_t, level), level)
        cs = p.ring_q.mul_mont(crp, sk.value.q[..., : level + 1, :], level)
        e = noise_ntt(gen, p, self.noise_sigma, level, tuple(mask_t.shape[:-2]))
        return p.ring_q.add(p.ring_q.sub(e, cs, level), mask_q, level)

    def aggregate_shares(self, s1, s2):
        return self.params.ring_q.add(s1, s2, s1.shape[-2] - 1)

    def finalize(self, agg, crp, extra_mask_t=None, scale: int = 1,
                 level: int | None = None) -> Ciphertext:
        """(Σ h'_i [+ Enc_Q(extra mask)], crp)."""
        p = self.params
        level = p.max_level if level is None else level
        c0 = agg
        if extra_mask_t is not None:
            lifted = p.ring_q.ntt(self.encoder.ring_t_to_q(extra_mask_t, level), level)
            c0 = p.ring_q.add(c0, lifted, level)
        crp = crp.expand(c0.shape)
        return Ciphertext(value=torch.stack([c0, crp], dim=-3), is_ntt=True,
                          scale=scale)


@dataclass
class MaskedTransformFunc:
    """User transform over Z_T vectors: ``fn`` maps uint64[..., N] mod T to
    uint64[..., N] mod T (numpy, on the host). With ``decode`` its input is
    in slot order at the ciphertext's scale; with ``encode`` its output is
    re-encoded to R_T coefficients."""

    fn: Callable
    decode: bool = False
    encode: bool = False


class BGVMaskedTransformProtocol:
    """One-round refresh with a transform applied to the R_T masks."""

    def __init__(self, params: Parameters, noise_sigma: float = 3.2):
        self.params = params
        self.e2s = BGVEncToShareProtocol(params, noise_sigma)
        self.s2e = BGVShareToEncProtocol(params, noise_sigma)
        self.encoder = self.e2s.encoder

    def sample_crp(self, seed: bytes, level: int | None = None):
        return self.s2e.sample_crp(seed, level)

    def _apply(self, transform: MaskedTransformFunc | None, mask_t, scale: int):
        if transform is None:
            return mask_t
        p = self.params
        if transform.decode:
            m = p.ring_t.mul_scalar(mask_t, pow(int(scale), -1, p.t))
            vals = self.encoder.decode_ring_t(m).cpu().numpy().astype(np.uint64)
        else:
            vals = mask_t[..., 0, :].cpu().numpy().astype(np.uint64)
        out = np.asarray(transform.fn(vals), dtype=np.uint64)
        if transform.encode:
            m2 = self.encoder.encode_ring_t(out)
            return p.ring_t.mul_scalar(m2, int(scale) % p.t)
        return u64_tensor(out, p.device)[..., None, :]

    def gen_share(self, gen: torch.Generator, sk: SecretKey, ct: Ciphertext,
                  crp, transform: MaskedTransformFunc | None = None,
                  level_out: int | None = None):
        """→ (h_e2s at the ct's level, h_s2e at ``level_out``)."""
        mask_t, h = self.e2s.gen_share(gen, sk, ct)
        m2 = self._apply(transform, mask_t, ct.scale)
        return h, self.s2e.gen_share(gen, sk, m2, crp, level_out)

    def aggregate_shares(self, s1, s2):
        return (self.e2s.aggregate_shares(s1[0], s2[0]),
                self.s2e.aggregate_shares(s1[1], s2[1]))

    def finalize(self, ct: Ciphertext, agg, crp,
                 transform: MaskedTransformFunc | None = None,
                 level_out: int | None = None) -> Ciphertext:
        """Decrypt to the masked R_T value, transform it, re-encrypt."""
        level_out = self.params.max_level if level_out is None else level_out
        pub_t = self._apply(transform, self.e2s.get_share(None, agg[0], ct), ct.scale)
        return self.s2e.finalize(agg[1], crp, extra_mask_t=pub_t,
                                 scale=ct.scale, level=level_out)


class BGVRefreshProtocol(BGVMaskedTransformProtocol):
    """Collective BGV bootstrap: the masked transform with the identity."""

    def gen_share(self, gen, sk, ct, crp, level_out=None):  # noqa: D102
        return super().gen_share(gen, sk, ct, crp, None, level_out)

    def finalize(self, ct, agg, crp, level_out=None):  # noqa: D102
        return super().finalize(ct, agg, crp, None, level_out)
