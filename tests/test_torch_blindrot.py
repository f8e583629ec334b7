"""Port parity for the blind-rotation slice: automorphisms, Galois keys, RGSW
and the LMKCDEY blind rotation, against lattigo_tpu.

At the BR parameters of tests/test_blindrot.py (logN 9, one 28-bit Q, one
32-bit P):

* the automorphism index tables equal the JAX package's;
* Galois keys, RGSW ciphertexts and a ciphertext made by the JAX package
  and carried across with ``interop`` give bit-equal ``automorphism``,
  ``automorphism_hoisted`` and ``external_product`` results, and a
  bit-equal blind-rotation core (``_core``) on an ``a`` vector with a few
  nonzero entries (one per branch: negative set, positive set, ±0
  buckets), so the JAX side stays inside tier-1's time;
* keys the port draws itself decrypt correctly: RGSW(X^k) ⊠ ct decrypts to
  X^k·m, σ_g(ct) to σ_g(m);
* the port's whole blind rotation at logN 9 / 7 with 8 slots meets the sign
  check of tests/test_blindrot.py.

Exact comparisons unless a tolerance is stated.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lattigo_tpu import rlwe as jrlwe
from lattigo_tpu.rgsw import blindrot as jbr, rgsw as jrgsw
from lattigo_tpu.ring import automorphism as jauto
from lattigo_tpu_torch import interop, rlwe as trlwe
from lattigo_tpu_torch.rgsw import blindrot as tbr, rgsw as trgsw
from lattigo_tpu_torch.ring import automorphism as tauto

BR = dict(log_n=9, log_q=(28,), log_p=(32,))
LWE = dict(log_n=7, log_q=(14,), log_p=(15,))
GAL_ELS = sorted({pow(5, v, 1024) for v in range(1, 11)} | {1024 - 5})
POWERS = (3, 700, -1)            # X^3, X^700 = −X^188, X^{-1} = −X^511


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here, and
    they crowd the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sign(x):
    return 1.0 if x > 0 else (-1.0 if x < 0 else 0.0)


def test_automorphism_index_tables():
    for n in (512, 1024):
        for g in (5, 25, 3, 2 * n - 5, 2 * n - 1):
            np.testing.assert_array_equal(tauto._ntt_index_np(n, g),
                                          jauto._ntt_index_np(n, g))
            ti, tn = tauto._coeff_index_np(n, g)
            ji, jn = jauto._coeff_index_np(n, g)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tn, jn)
    rng = np.random.default_rng(1)
    q = np.array([[12289], [65537]], dtype=np.uint64)
    x = rng.integers(0, 12289, (2, 512), dtype=np.uint64) % q
    want = np.asarray(jauto.apply_coeff(jnp.asarray(x), 512, 25, jnp.asarray(q)))
    got = tauto.apply_coeff(interop.to_torch(x, "cpu"), 512, 25,
                            interop.to_torch(q, "cpu"))
    np.testing.assert_array_equal(interop.to_numpy(got), want)


@pytest.fixture(scope="module")
def ref():
    """JAX keys, RGSW ciphertexts and a ciphertext, as numpy arrays."""
    pj = jrlwe.Parameters(jrlwe.ParametersLiteral(**BR))
    pt = trlwe.Parameters(trlwe.ParametersLiteral(**BR), device="cpu")
    k_sk, k_gk, k_rg, k_ct = jax.random.split(jax.random.PRNGKey(7), 4)
    kg = jrlwe.KeyGenerator(pj)
    sk = kg.gen_secret_key(k_sk)
    gks = kg.gen_galois_keys(k_gk, GAL_ELS, sk)
    enc = jrgsw.Encryptor(pj, sk)
    rg = {k: enc.encrypt_monomial(kk, k)
          for k, kk in zip(POWERS, jax.random.split(k_rg, len(POWERS)))}
    rng = np.random.default_rng(2)
    m = rng.integers(-1000, 1000, pj.n).tolist()
    pt_j = jrlwe.Plaintext(value=pj.ring_q.ntt(pj.ring_q.from_int_coeffs(m)))
    ct = jrlwe.Encryptor(pj, sk).encrypt(k_ct, pt_j)
    a = lambda x: np.asarray(x)                                   # noqa: E731
    return dict(
        pj=pj, pt=pt, sk=sk, gks=gks, rg=rg, ct=ct, m=m,
        gks_np={g: (a(k.gadget.value.q), a(k.gadget.value.p)) for g, k in gks.items()},
        rg_np={k: ((a(r.c0.value.q), a(r.c0.value.p)),
                   (a(r.c1.value.q), a(r.c1.value.p))) for k, r in rg.items()},
        ct_np=a(ct.value))


def _port_ev(ref):
    gks = {g: interop.galois_key_from_numpy(q, p, g, "cpu")
           for g, (q, p) in ref["gks_np"].items()}
    return trlwe.Evaluator(ref["pt"], trlwe.EvaluationKeySet(galois_keys=gks))


def test_params_galois_helpers(ref):
    pj, pt = ref["pj"], ref["pt"]
    assert pt.q_moduli == pj.q_moduli and pt.p_moduli == pj.p_moduli
    assert pt.ring_q.ntt_engine == "u32-plain"
    assert pt.galois_gen == pj.galois_gen
    assert pt.galois_element_order_two == pj.galois_element_order_two
    for k in (1, 3, -2):
        assert pt.galois_element(k) == pj.galois_element(k)
        g = pj.galois_element(k)
        assert pt.galois_element_inverse(g) == pj.galois_element_inverse(g)


@pytest.mark.parametrize("gal_el", [5, 25, 1019])
def test_automorphism_bit_equal(ref, gal_el):
    jev = jrlwe.Evaluator(ref["pj"], jrlwe.EvaluationKeySet(galois_keys=ref["gks"]))
    want = np.asarray(jev.automorphism(ref["ct"], gal_el).value)
    ev = _port_ev(ref)
    ct = interop.ciphertext_from_numpy(ref["ct_np"], "cpu")
    np.testing.assert_array_equal(
        interop.to_numpy(ev.automorphism(ct, gal_el).value), want)
    digits = ev.decompose_ntt(ct.value[..., 1, :, :], ct.level)
    np.testing.assert_array_equal(
        interop.to_numpy(ev.automorphism_hoisted(ct, digits, gal_el).value), want)


def test_missing_galois_key(ref):
    ev = _port_ev(ref)
    ct = interop.ciphertext_from_numpy(ref["ct_np"], "cpu")
    with pytest.raises(trlwe.MissingGaloisKeyError, match="gen_galois_keys"):
        ev.automorphism(ct, 7)


@pytest.mark.parametrize("power", POWERS)
def test_external_product_bit_equal(ref, power):
    jev = jrlwe.Evaluator(ref["pj"])
    want = np.asarray(jrgsw.external_product(jev, ref["ct"], ref["rg"][power]).value)
    rg = interop.rgsw_from_numpy(*ref["rg_np"][power], "cpu")
    ct = interop.ciphertext_from_numpy(ref["ct_np"], "cpu")
    got = trgsw.external_product(trlwe.Evaluator(ref["pt"]), ct, rg)
    np.testing.assert_array_equal(interop.to_numpy(got.value), want)


def test_blind_rotation_core_bit_equal(ref):
    pj, pt = ref["pj"], ref["pt"]
    two_n = 2 * pj.n
    n_lwe = 1 << LWE["log_n"]
    # one entry per branch of _core: -g^3, +g^7, +0 (a_j = 1), -0 (2N-1)
    a = np.zeros(n_lwe, dtype=np.uint64)
    entries = {5: two_n - pow(5, 3, two_n), 9: pow(5, 7, two_n), 20: 1,
               33: two_n - 1}
    key_of = {5: 3, 9: 700, 20: -1, 33: 3}
    for j, v in entries.items():
        a[j] = v
    jbrk = jbr.BlindRotationKeySet(
        brk=[ref["rg"][key_of[j]] if j in entries else None for j in range(n_lwe)],
        evk=jrlwe.EvaluationKeySet(galois_keys=ref["gks"]))
    jev = jbr.BlindRotationEvaluator(pj, jrlwe.Parameters(jrlwe.ParametersLiteral(**LWE)))
    want = np.asarray(jev._core(a, ref["ct"], jrlwe.Evaluator(pj, jbrk.evk), jbrk,
                                jbr.WINDOW_SIZE).value)

    brk = interop.blind_rotation_keys_from_numpy(
        [ref["rg_np"][key_of[j]] if j in entries else None for j in range(n_lwe)],
        ref["gks_np"], "cpu")
    tev = tbr.BlindRotationEvaluator(pt, trlwe.Parameters(
        trlwe.ParametersLiteral(**LWE), device="cpu"))
    ct = interop.ciphertext_from_numpy(ref["ct_np"], "cpu")
    got = tev._core(a.astype(np.int64), ct, trlwe.Evaluator(pt, brk.evk), brk,
                    tbr.WINDOW_SIZE)
    np.testing.assert_array_equal(interop.to_numpy(got.value), want)


def _decrypt_ints(params, sk, ct):
    dec = trlwe.Decryptor(params, sk).decrypt(ct)
    return np.array(params.ring_q.to_int_coeffs(params.ring_q.intt(dec.value)))


def _negacyclic_shift(m, k):
    n = len(m)
    out = np.zeros(n, dtype=np.int64)
    for i, v in enumerate(m):
        j = (i + k) % (2 * n)
        out[j % n] += v if j < n else -v
    return out


def test_port_keys_decrypt():
    """Keys the port draws itself: RGSW(X^k) ⊠ ct → X^k·m and σ_g(ct) →
    σ_g(m), within the key-switching noise (|error| < 2^12 against a
    message of scale 2^20)."""
    pt = trlwe.Parameters(trlwe.ParametersLiteral(**BR), device="cpu")
    gen = torch.Generator().manual_seed(11)
    kg = trlwe.KeyGenerator(pt)
    sk = kg.gen_secret_key(gen)
    ev = trlwe.Evaluator(pt, trlwe.EvaluationKeySet(
        galois_keys=kg.gen_galois_keys(gen, [5, 1019], sk)))
    rng = np.random.default_rng(3)
    m = rng.integers(-8, 8, pt.n) << 20
    ct = trlwe.Encryptor(pt, sk).encrypt(gen, trlwe.Plaintext(
        value=pt.ring_q.ntt(pt.ring_q.from_int_coeffs(m.tolist()))))
    keys = trgsw.Encryptor(pt, sk).encrypt_monomials(gen, list(POWERS))
    for k, key in zip(POWERS, keys):
        got = _decrypt_ints(pt, sk, trgsw.external_product(ev, ct, key))
        assert np.abs(got - _negacyclic_shift(m, k)).max() < 1 << 12, k
    q = pt.ring_q.q
    for g in (5, 1019):
        want = tauto.apply_coeff(pt.ring_q.from_int_coeffs(m.tolist()), pt.n, g, q)
        want = np.array(pt.ring_q.to_int_coeffs(want))
        got = _decrypt_ints(pt, sk, ev.automorphism(ct, g))
        assert np.abs(got - want).max() < 1 << 12, g


def test_port_blind_rotation_sign():
    """The port's whole blind rotation on the CPU, as tests/test_blindrot.py
    runs the JAX package's: every slot with x ≠ 0 decodes to sign(x)."""
    pbr = trlwe.Parameters(trlwe.ParametersLiteral(**BR), device="cpu")
    plwe = trlwe.Parameters(trlwe.ParametersLiteral(**LWE), device="cpu")
    gen = torch.Generator().manual_seed(0)
    sk_lwe = trlwe.KeyGenerator(plwe).gen_secret_key(gen)
    sk_br = trlwe.KeyGenerator(pbr).gen_secret_key(gen)
    q_lwe, q_br = plwe.q_moduli[0], pbr.q_moduli[0]
    slots = 8
    values = [-1 + 2 * i / slots for i in range(slots)]
    coeffs = [0] * plwe.n
    for i, v in enumerate(values):
        coeffs[i] = int(round(v * q_lwe / 4.0))
    pt = trlwe.Plaintext(value=plwe.ring_q.ntt(plwe.ring_q.from_int_coeffs(coeffs, 0), 0))
    ct = trlwe.Encryptor(plwe, sk_lwe).encrypt(gen, pt)
    f = tbr.init_test_polynomial(sign, q_br / 4.0, pbr, -1.0, 1.0)
    brk = tbr.gen_evaluation_keys(gen, pbr, sk_br, plwe, sk_lwe)
    assert len(brk.brk) == plwe.n and sorted(brk.evk.galois_keys) == GAL_ELS
    out = tbr.BlindRotationEvaluator(pbr, plwe).evaluate(
        ct, {i: f for i in range(slots)}, brk)
    dec = trlwe.Decryptor(pbr, sk_br)
    ok = 0
    for i, v in enumerate(values):
        if v == 0:
            continue
        ptb = dec.decrypt(out[i])
        c = int(pbr.ring_q.intt(ptb.value)[0, 0])
        x = (c - q_br if c >= q_br // 2 else c) / (q_br / 4.0)
        assert abs(round(x * 8) / 8 - sign(v)) < 0.25, (i, v, x)
        ok += 1
    assert ok == slots - 1
