"""Port parity for the conjugate-invariant (CI) ring Z[X+X^{-1}]/(X^{2N}+1).

Host tables and transforms with tolerance 0: the CI root tables, ``ntt_ci``
/ ``intt_ci`` lazy and not at logN 7–9 on 45-bit and 28-bit primes, and
the CI automorphism index, against the JAX package (its transforms under
one ``jax.jit`` per ring). CI products against the folded product of the
standard 2N ring (``tests/test_ci_ring.py``'s oracle). ``CIEncoder``'s
embedding, residues and decoding against the JAX package's. Then CKKS on
the CI ring at ``tests/test_ckks_ci.py``'s parameters (logN 9): the port
makes the keys and ciphertexts, the JAX package runs ``mul_relin``,
``rescale``, ``add``, a rotation and the trace on them under one
``jax.jit``, and every residue must be equal with an equal ``Fraction``
scale; the trace skips the order-two element on a CI ring, as the JAX
package does. The port's results decrypt at that file's floors. Last, the
``CKKS_REAL_*`` presets draw the JAX package's primes.
"""

import contextlib
from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lattigo_tpu import presets as jpresets, rlwe as jrlwe
from lattigo_tpu.ring import automorphism as jauto, ntt as jntt
from lattigo_tpu.ring.ring import Ring as JRing
from lattigo_tpu.ring.ringqp import QPPoly as JQPPoly
from lattigo_tpu.rlwe.params import gen_moduli as j_gen_moduli
from lattigo_tpu.schemes import ckks as jckks
from lattigo_tpu.schemes.ckks.encoder import CIEncoder as JCIEncoder
from lattigo_tpu.utils.primes import NTTFriendlyPrimesGenerator
from lattigo_tpu_torch import interop, presets as tpresets, rlwe as trlwe
from lattigo_tpu_torch.ring import automorphism as tauto
from lattigo_tpu_torch.ring.ring import CONJUGATE_INVARIANT, Ring as TRing, select_engine
from lattigo_tpu_torch.rlwe.params import gen_moduli as t_gen_moduli
from lattigo_tpu_torch.schemes import ckks as tckks

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
CKKS_LIT = dict(log_n=9, log_q=(50, 40, 40), log_p=(55,), log_default_scale=40,
                ring_type=CONJUGATE_INVARIANT)
ROT = 3                       # tests/test_ckks_ci.py's rotation


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's ops here act on small tensors, where torch's intra-op
    threads only add overhead: one thread runs this file faster and leaves
    the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jit_gadget_products(ev):
    """Route the JAX evaluator ``ev``'s gadget products (every key switch)
    through one nested ``jax.jit``: inside an outer jit, JAX then traces
    the key switch once per shape, not once per call."""
    fn = jax.jit(lambda c2, gadget, level: type(ev).gadget_product(ev, c2, gadget, level),
                 static_argnums=2)
    ev.gadget_product = fn
    return ev


@contextlib.contextmanager
def jitted_constant_ntts(*methods):
    """While the block runs, each JAX method of ``methods`` ((class, name)
    pairs: methods that compute a constant with the radix-2 NTT eagerly, op
    by op, inside a trace, one XLA compile per op and shape) runs that NTT
    as one ``jax.jit`` per shape. The NTT is non-lazy, so its output is
    canonical either way."""
    ntt_jit = jax.jit(jntt.ntt, static_argnums=(4, 5))
    saved = {m: getattr(*m) for m in methods}

    def jitted(orig):
        def method(*args, **kw):
            eager, jntt.ntt = jntt.ntt, ntt_jit
            try:
                return orig(*args, **kw)
            finally:
                jntt.ntt = eager
        return method

    for (cls, name), orig in saved.items():
        setattr(cls, name, jitted(orig))
    try:
        yield
    finally:
        for (cls, name), orig in saved.items():
            setattr(cls, name, orig)


def _moduli(bits: int, n: int, count: int = 2) -> list[int]:
    gen = NTTFriendlyPrimesGenerator(bits, 4 * n)
    return [gen.next_alternating_prime() for _ in range(count)]


# -- tables, transforms, automorphism index -------------------------------------

@pytest.mark.parametrize("bits", [45, 28])
@pytest.mark.parametrize("log_n", [7, 8, 9])
def test_ci_tables_and_transforms(bits, log_n):
    n = 1 << log_n
    moduli = _moduli(bits, n)
    jr = JRing(n, moduli, "conjugate_invariant")
    tr = TRing(n, moduli, CONJUGATE_INVARIANT, device="cpu")
    assert tr.ntt_engine == "ci-plain" and select_engine(n, moduli, CONJUGATE_INVARIANT) == "radix2"
    for name in ("ci_roots", "ci_iroots", "ci_f_fwd", "ci_f_inv", "ci_ninv"):
        np.testing.assert_array_equal(interop.to_numpy(getattr(tr, name)),
                                      np.asarray(getattr(jr, name)))
    rng = np.random.default_rng(log_n)
    x = rng.integers(0, min(moduli), (3, 2, n)).astype(np.uint64)

    def transforms(r, v):
        return [r.ntt(v), r.ntt(v, lazy=True), r.intt(v), r.intt(v, lazy=True),
                r.ntt_single(1, v[:, 1:]), r.intt_single(0, v[:, :1], lazy=True)]

    want = jax.jit(lambda v: transforms(jr, v), compiler_options=FAST_COMPILE)(x)
    got = transforms(tr, interop.to_torch(x, "cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(interop.to_numpy(g), np.asarray(w))
    back = tr.intt(tr.ntt(interop.to_torch(x, "cpu")))
    np.testing.assert_array_equal(interop.to_numpy(back), x)


@pytest.mark.parametrize("log_n", [7, 8, 9])
def test_ci_automorphism_index(log_n):
    n = 1 << log_n
    els = [pow(5, k, 4 * n) for k in (1, 2, 3, n - 1, n // 2)]
    els += [4 * n - 1, 4 * n - 5, 2 * n + 1, 3]
    for g in els:
        want = jauto._ntt_index_ci_np(n, g)
        np.testing.assert_array_equal(tauto._ntt_index_ci_np(n, g), want)
        np.testing.assert_array_equal(
            tauto.ntt_index(n, g, "cpu", CONJUGATE_INVARIANT).numpy(), want)
        std = g % (2 * n)
        np.testing.assert_array_equal(tauto.ntt_index(n, std, "cpu").numpy(),
                                      jauto.ntt_index(n, std))


def _unfold(c, q, n):
    s = [0] * (2 * n)
    s[0] = int(c[0])
    for j in range(1, n):
        s[j] = int(c[j])
        s[2 * n - j] = (q - int(c[j])) % q
    return s


@pytest.mark.parametrize("bits", [45, 28])
def test_ci_mul_matches_standard_2n(bits):
    """The CI product is the σ-invariant product of the standard 2N ring,
    folded back."""
    n = 128
    moduli = _moduli(bits, n)
    ci = TRing(n, moduli, CONJUGATE_INVARIANT, device="cpu")
    std = TRing(2 * n, moduli, device="cpu")
    rng = np.random.default_rng(bits)
    a = rng.integers(0, min(moduli), n)
    b = rng.integers(0, min(moduli), n)
    va = ci.ntt(ci.from_int_coeffs(list(a)))
    vb = ci.ntt(ci.from_int_coeffs(list(b)))
    got = interop.to_numpy(ci.intt(ci.mul_mont(ci.mform(va), vb)))
    for i, q in enumerate(moduli):
        ua = std.ntt(std.from_int_coeffs(_unfold(a, q, n)))
        ub = std.ntt(std.from_int_coeffs(_unfold(b, q, n)))
        prod = interop.to_numpy(std.intt(std.mul_mont(std.mform(ua), ub)))[i]
        assert int(prod[n]) == 0
        assert all((int(prod[j]) + int(prod[2 * n - j])) % q == 0 for j in range(1, n))
        np.testing.assert_array_equal(got[i], prod[:n])


# -- CKKS on the CI ring ----------------------------------------------------------

@pytest.fixture(scope="module")
def ci_ckks():
    """The port's keys (secret, relinearization, the rotation's and the
    trace's Galois keys) and two ciphertexts, and the JAX package's
    results on them."""
    pt = tckks.Parameters(tckks.ParametersLiteral(**CKKS_LIT), device="cpu")
    pj = jckks.Parameters(jckks.ParametersLiteral(**CKKS_LIT))
    assert (pt.q_moduli, pt.p_moduli) == (pj.q_moduli, pj.p_moduli)
    assert pt.max_slots == pt.n and pt.nth_root == 4 * pt.n
    gen = torch.Generator().manual_seed(9)
    kg = trlwe.KeyGenerator(pt)
    sk = kg.gen_secret_key(gen)
    rot = pt.galois_element(ROT)
    tev0 = tckks.Evaluator(pt)
    jev0 = jckks.Evaluator(pj)
    els = {0: tev0.galois_elements_for_trace(0), 5: tev0.galois_elements_for_trace(5)}
    assert els == {k: jev0.galois_elements_for_trace(k) for k in els}
    assert pt.galois_element_order_two not in els[0]
    gal = sorted({rot, *els[0], *els[5]})
    evk = trlwe.EvaluationKeySet(kg.gen_relinearization_key(gen, sk),
                                 kg.gen_galois_keys(gen, gal, sk))
    enc = tckks.CIEncoder(pt)
    rng = np.random.default_rng(1)
    v1, v2 = rng.uniform(-1, 1, (2, pt.n))
    encryptor = trlwe.Encryptor(pt, sk)
    ct1, ct2 = (encryptor.encrypt(gen, enc.encode(v)) for v in (v1, v2))
    scale = pt.default_scale_fraction
    meta = {}

    def ops(ev, a, b):
        return {"mul_relin_rescale": ev.rescale(ev.mul_relin(a, b)),
                "add": ev.add(a, b), "rotate": ev.automorphism(a, rot),
                "rotate_k": ev.rotate(b, ROT), "trace0": ev.trace(a, 0),
                "trace5": ev.trace(b, 5)}

    def run(rlk, gks, a, b):
        jevk = jrlwe.EvaluationKeySet(
            jrlwe.RelinearizationKey(jrlwe.GadgetCiphertext(JQPPoly(*rlk))),
            {g: jrlwe.GaloisKey(jrlwe.GadgetCiphertext(JQPPoly(*k)), g)
             for g, k in gks.items()})
        out = ops(jit_gadget_products(jckks.Evaluator(pj, jevk)), jrlwe.Ciphertext(value=a, scale=scale),
                  jrlwe.Ciphertext(value=b, scale=scale))
        meta.update({k: Fraction(o.scale) for k, o in out.items()})
        return {k: o.value for k, o in out.items()}

    ref = jax.tree_util.tree_map(np.asarray, jax.jit(run, compiler_options=FAST_COMPILE)(
        interop.qp_to_numpy(evk.relinearization_key.gadget.value),
        {g: interop.qp_to_numpy(k.gadget.value) for g, k in evk.galois_keys.items()},
        interop.to_numpy(ct1.value), interop.to_numpy(ct2.value)))
    port = ops(tckks.Evaluator(pt, evk), ct1, ct2)
    return dict(pt=pt, pj=pj, sk=sk, enc=enc, v1=v1, v2=v2, ref=ref, meta=meta,
                port=port)


@pytest.mark.parametrize("op", ["mul_relin_rescale", "add", "rotate", "rotate_k",
                                "trace0", "trace5"])
def test_ci_ckks_bit_equal(ci_ckks, op):
    got = ci_ckks["port"][op]
    assert Fraction(got.scale) == ci_ckks["meta"][op]
    np.testing.assert_array_equal(interop.to_numpy(got.value), ci_ckks["ref"][op])


def test_ci_ckks_decrypts(ci_ckks):
    pt, enc, port = ci_ckks["pt"], ci_ckks["enc"], ci_ckks["port"]
    dec = trlwe.Decryptor(pt, ci_ckks["sk"])
    v1, v2 = ci_ckks["v1"], ci_ckks["v2"]

    def got(op):
        return enc.decode(dec.decrypt(port[op]))

    assert np.isrealobj(got("add"))
    assert np.abs(got("mul_relin_rescale") - v1 * v2).max() < 1e-6
    assert np.abs(got("add") - (v1 + v2)).max() < 1e-8
    assert np.abs(got("rotate") - np.roll(v1, -ROT)).max() < 1e-8
    assert np.abs(got("rotate_k") - np.roll(v2, -ROT)).max() < 1e-8


def test_ci_encoder_parity(ci_ckks):
    pt, pj, enc = ci_ckks["pt"], ci_ckks["pj"], ci_ckks["enc"]
    jenc = JCIEncoder(pj)
    np.testing.assert_array_equal(enc.exponents, jenc.exponents)
    rng = np.random.default_rng(2)
    v = rng.uniform(-1, 1, (2, pt.n))
    coeffs = enc.embed_to_coeffs(v)
    np.testing.assert_array_equal(coeffs, jenc.embed_to_coeffs(v))
    np.testing.assert_array_equal(enc.embed_to_coeffs(v[0, :100]),
                                  jenc.embed_to_coeffs(v[0, :100]))
    np.testing.assert_array_equal(enc.coeffs_to_slots(coeffs), jenc.coeffs_to_slots(coeffs))
    scale = Fraction(2) ** 38
    pt_t = enc.encode(v[0], level=1, scale=scale)
    assert pt_t.scale == scale and pt_t.level == 1
    want, coeff = jax.jit(lambda: (lambda p: (p.value, pj.ring_q.intt(p.value, 1)))(
        jenc.encode(v[0], level=1, scale=scale)), compiler_options=FAST_COMPILE)()
    np.testing.assert_array_equal(interop.to_numpy(pt_t.value), np.asarray(want))
    dec_j = jenc.decode(jrlwe.Plaintext(value=np.asarray(coeff), is_ntt=False, scale=scale))
    np.testing.assert_array_equal(enc.decode(pt_t), dec_j)
    assert np.abs(dec_j - v[0]).max() < 1e-9
    with pytest.raises(ValueError, match="CIEncoder"):
        tckks.Encoder(pt)


# -- presets ------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(5))
def test_real_presets_equal(i):
    jl, tl = jpresets.CKKS_REAL_PARAMS[i], tpresets.CKKS_REAL_PARAMS[i]
    assert vars(tl).keys() == vars(jl).keys()
    for f in ("log_n", "log_q", "log_p", "log_default_scale", "ring_type"):
        assert getattr(tl, f) == getattr(jl, f)
    assert tl.ring_type == CONJUGATE_INVARIANT
    nth = 4 << tl.log_n
    assert t_gen_moduli(tl.log_n, nth, tl.log_q, tl.log_p) == j_gen_moduli(
        jl.log_n, nth, jl.log_q, jl.log_p)
