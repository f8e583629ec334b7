"""Port parity for the whole slice: a batched BGV mul_relin + rescale.

At logN=12 (the smallest N on the four-step engine) with 4 Q and 2 P
28-bit limbs: the port's moduli equal the JAX package's; JAX keys and
ciphertexts carried over through ``interop`` give a bit-equal
``rescale(mul_relin(·))``; the encoders agree; and the port's own keys and
ciphertexts decrypt to the numpy oracle in the port and, carried back, in
JAX. The JAX side runs under one ``jax.jit`` per program.
"""

import numpy as np
import jax
import pytest
import torch

from lattigo_tpu import presets as jpresets, rlwe as jrlwe
from lattigo_tpu.ring.ringqp import QPPoly as JQPPoly
from lattigo_tpu.rlwe.params import gen_moduli as j_gen_moduli
from lattigo_tpu.schemes import bgv as jbgv
from lattigo_tpu_torch import interop, presets as tpresets, rlwe as trlwe
from lattigo_tpu_torch.rlwe.params import gen_moduli as t_gen_moduli
from lattigo_tpu_torch.schemes import bgv as tbgv

LOG_N, LOG_Q, LOG_P, T = 12, (28,) * 4, (28, 28), 65537
BATCH = 2


def _jax_encode(p, enc, slots):
    """lattigo_tpu Encoder.encode at scale 1, minus its host permutation."""
    return p.ring_q.ntt(enc.ring_t_to_q(p.ring_t.intt(slots[..., None, :])))


def _jax_decode(p, enc, v, level, scale):
    """lattigo_tpu Encoder.decode in NTT-slot order (before the permutation)."""
    coeffs = enc.ring_q_to_t(p.ring_q.intt(v, level), level)
    if scale != 1:
        coeffs = p.ring_t.mul_scalar(coeffs, pow(scale, -1, p.t))
    return p.ring_t.ntt(coeffs)[..., 0, :]


@pytest.fixture(scope="module")
def ref():
    pj = jbgv.Parameters(jbgv.ParametersLiteral(
        log_n=LOG_N, log_q=LOG_Q, log_p=LOG_P, t=T))
    pt = tbgv.Parameters(tbgv.ParametersLiteral(
        log_n=LOG_N, log_q=LOG_Q, log_p=LOG_P, t=T), device="cpu")
    encj = jbgv.Encoder(pj)
    rng = np.random.default_rng(12)
    va = rng.integers(0, T, (BATCH, pj.n))
    vb = rng.integers(0, T, (BATCH, pj.n))

    def slots(v):
        s = np.zeros(v.shape, dtype=np.uint64)
        s[..., encj.perm] = v
        return s

    kg = jrlwe.KeyGenerator(pj)
    level = pj.max_level
    out_scale = pj.scale_div_q(1, level)

    def setup(key, sa, sb):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        sk = kg.gen_secret_key(k1)
        rlk = kg.gen_relinearization_key(k2, sk)
        enc = jrlwe.Encryptor(pj, sk)
        pa = jrlwe.Plaintext(value=_jax_encode(pj, encj, sa))
        pb = jrlwe.Plaintext(value=_jax_encode(pj, encj, sb))
        ca = enc.encrypt(k3, pa, batch=(BATCH,))
        cb = enc.encrypt(k4, pb, batch=(BATCH,))
        ev = jbgv.Evaluator(pj, jrlwe.EvaluationKeySet(rlk))
        out = ev.rescale(ev.mul_relin(ca, cb))
        dec = jrlwe.Decryptor(pj, sk).decrypt(out)
        return dict(sk_q=sk.value.q, sk_p=sk.value.p,
                    rlk_q=rlk.gadget.value.q, rlk_p=rlk.gadget.value.p,
                    pa=pa.value, ca=ca.value, cb=cb.value, out=out.value,
                    slots=_jax_decode(pj, encj, dec.value, level - 1, out_scale))

    arrays = jax.jit(setup)(jax.random.PRNGKey(3), slots(va), slots(vb))
    arrays = {k: np.asarray(v) for k, v in arrays.items()}

    def jax_decrypt_decode(sk_q, sk_p, v):
        sk = jrlwe.SecretKey(JQPPoly(sk_q, sk_p))
        ct = jrlwe.Ciphertext(value=v)
        dec = jrlwe.Decryptor(pj, sk).decrypt(ct)
        return _jax_decode(pj, encj, dec.value, ct.level, out_scale)

    return dict(pj=pj, pt=pt, encj=encj, va=va, vb=vb, arrays=arrays,
                level=level, out_scale=out_scale,
                jax_dec=jax.jit(jax_decrypt_decode))


def test_moduli_match(ref):
    pj, pt = ref["pj"], ref["pt"]
    assert pt.q_moduli == pj.q_moduli and pt.p_moduli == pj.p_moduli
    assert pt.ring_t.moduli == pj.ring_t.moduli
    # the slice's configuration: logN=14, 13 + 2 primes < 2^29
    jl, tl = jpresets.bgv_tpu_params(14, 438), tpresets.bgv_tpu_params(14, 438)
    assert (tl.log_q, tl.log_p, tl.t) == (jl.log_q, jl.log_p, jl.t)
    q, p = t_gen_moduli(14, 2 << 14, tl.log_q, tl.log_p)
    assert (q, p) == j_gen_moduli(14, 2 << 14, jl.log_q, jl.log_p)
    assert len(q) == 13 and len(p) == 2 and max(q + p) < (1 << 29)


def test_engines(ref):
    pt = ref["pt"]
    for ring in (pt.ring_q, pt.ring_p, pt.ring_t):
        assert ring.ntt_engine == "mxu-plain"


def test_encoder_parity(ref):
    pt, a = ref["pt"], ref["arrays"]
    enc = tbgv.Encoder(pt)
    got = enc.encode(ref["va"])
    np.testing.assert_array_equal(interop.to_numpy(got.value), a["pa"])
    back = enc.decode(interop.plaintext_from_numpy(a["pa"], "cpu"))
    np.testing.assert_array_equal(back, ref["va"])


def test_mul_relin_rescale_bit_equal(ref):
    pt, a, encj = ref["pt"], ref["arrays"], ref["encj"]
    sk = interop.secret_key_from_numpy(a["sk_q"], a["sk_p"], "cpu")
    rlk = interop.relinearization_key_from_numpy(a["rlk_q"], a["rlk_p"], "cpu")
    ca = interop.ciphertext_from_numpy(a["ca"], "cpu")
    cb = interop.ciphertext_from_numpy(a["cb"], "cpu")
    ev = tbgv.Evaluator(pt, trlwe.EvaluationKeySet(rlk))
    out = ev.rescale(ev.mul_relin(ca, cb))
    assert out.level == ref["level"] - 1 and out.scale == ref["out_scale"]
    np.testing.assert_array_equal(interop.to_numpy(out.value), a["out"])
    want = ref["va"] * ref["vb"] % pt.t
    np.testing.assert_array_equal(a["slots"][..., encj.perm], want)
    dec = trlwe.Decryptor(pt, sk).decrypt(out)
    np.testing.assert_array_equal(tbgv.Encoder(pt).decode(dec), want)


def test_port_keys_and_encryption(ref):
    pt = ref["pt"]
    gen = torch.Generator().manual_seed(5)
    kg = trlwe.KeyGenerator(pt)
    sk = kg.gen_secret_key(gen)
    rlk = kg.gen_relinearization_key(gen, sk)
    enc = tbgv.Encoder(pt)
    encryptor = trlwe.Encryptor(pt, sk)
    ca = encryptor.encrypt(gen, enc.encode(ref["va"]), batch=(BATCH,))
    cb = encryptor.encrypt(gen, enc.encode(ref["vb"]), batch=(BATCH,))
    dec = trlwe.Decryptor(pt, sk)
    np.testing.assert_array_equal(enc.decode(dec.decrypt(ca)), ref["va"])
    ev = tbgv.Evaluator(pt, trlwe.EvaluationKeySet(rlk))
    out = ev.rescale(ev.mul_relin(ca, cb))
    want = ref["va"] * ref["vb"] % pt.t
    np.testing.assert_array_equal(enc.decode(dec.decrypt(out)), want)
    # carried back: the JAX package decrypts and decodes the port's result
    sk_q, sk_p = interop.qp_to_numpy(sk.value)
    slots = np.asarray(ref["jax_dec"](sk_q, sk_p, interop.to_numpy(out.value)))
    np.testing.assert_array_equal(slots[..., ref["encj"].perm], want)
