"""RLWE secret-key encryption / decryption.

Counterpart of the sk path of :mod:`lattigo_tpu.rlwe.encryption`. Fresh
ciphertexts are plain-form (never Montgomery), in the NTT domain iff
``params.ntt_flag``; a batch is a leading axis.
"""

from __future__ import annotations

import torch

from lattigo_tpu_torch.ring import sampling
from lattigo_tpu_torch.rlwe.elements import (
    Ciphertext, Plaintext, ciphertext_from_polys,
)
from lattigo_tpu_torch.rlwe.keys import SecretKey
from lattigo_tpu_torch.rlwe.params import Parameters


class Encryptor:
    """Encryption under a secret key (public-key encryption is not ported
    yet)."""

    def __init__(self, params: Parameters, enc_key: SecretKey):
        if not isinstance(enc_key, SecretKey):
            raise NotImplementedError("only secret-key encryption is ported")
        self.params = params
        self.key = enc_key

    def encrypt_zero(self, gen: torch.Generator, level: int | None = None,
                     batch: tuple[int, ...] = ()) -> Ciphertext:
        """c1 uniform (NTT domain), c0 = -c1·s + e."""
        p = self.params
        level = p.max_level if level is None else level
        c1 = sampling.uniform(gen, p.ring_q, level, batch)
        e = p.ring_q.ntt(sampling.lift_signed(
            p.ring_q, sampling.signed(gen, p.n, p.xe, batch), level), level)
        c1s = p.ring_q.mul_mont(c1, self.key.value.q[..., : level + 1, :], level)
        ct = ciphertext_from_polys([p.ring_q.sub(e, c1s, level), c1], is_ntt=True)
        if not p.ntt_flag:
            ct = ct.replace(value=p.ring_q.intt(ct.value, level), is_ntt=False)
        return ct

    def encrypt(self, gen: torch.Generator, pt: Plaintext,
                batch: tuple[int, ...] = ()) -> Ciphertext:
        """ct = EncryptZero + pt."""
        return add_plaintext(self.params, self.encrypt_zero(gen, pt.level, batch), pt)


def add_plaintext(params: Parameters, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
    """ct[0] += pt, aligning NTT domains."""
    level = min(ct.level, pt.level)
    ptv = pt.value[..., : level + 1, :]
    if pt.is_ntt != ct.is_ntt:
        ptv = (params.ring_q.ntt(ptv, level) if ct.is_ntt
               else params.ring_q.intt(ptv, level))
    value = ct.value[..., : level + 1, :].clone()
    value[..., 0, :, :] = params.ring_q.add(value[..., 0, :, :], ptv, level)
    return ct.replace(value=value, scale=pt.scale)


class Decryptor:
    """pt = Σ_i ct[i]·s^i by Horner's rule in the NTT domain."""

    def __init__(self, params: Parameters, sk: SecretKey):
        self.params = params
        self.sk = sk

    def decrypt(self, ct: Ciphertext, out_ntt: bool | None = None) -> Plaintext:
        p = self.params
        level = ct.level
        s = self.sk.value.q[..., : level + 1, :]
        v = ct.value
        if not ct.is_ntt:
            v = p.ring_q.ntt(v, level)
        acc = v[..., ct.degree, :, :]
        for i in range(ct.degree - 1, -1, -1):
            acc = p.ring_q.add(p.ring_q.mul_mont(acc, s, level),
                               v[..., i, :, :], level)
        out_ntt = ct.is_ntt if out_ntt is None else out_ntt
        if not out_ntt:
            acc = p.ring_q.intt(acc, level)
        return Plaintext(value=acc, is_ntt=out_ntt, scale=ct.scale)
