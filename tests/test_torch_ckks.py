"""Port parity for the CKKS scheme: parameters, encoders, every evaluator op.

At logN=12 (the smallest N on the four-step engine) with 5 Q and 2 P 28-bit
limbs and scale 2^28 — the twin of ``ckks_tpu_params(14, 438)`` at a small
N: the port's moduli and scales equal the JAX package's, its encoders give
the same residues and the same decoded floats (to 2^-40 relative), and
every evaluator op on carried keys and ciphertexts gives the same residues
(tolerance 0) with the same exact ``Fraction`` scale. The JAX side runs
under one ``jax.jit``; scales, being host metadata, are read while it
traces. Then the port's own keys decrypt its results at the precision
floors of ``tests/test_ckks.py``, at that file's parameters.
"""

from fractions import Fraction

import numpy as np
import jax
import pytest
import torch

from lattigo_tpu import presets as jpresets, rlwe as jrlwe
from lattigo_tpu.rlwe.params import gen_moduli as j_gen_moduli
from lattigo_tpu.schemes import ckks as jckks
from lattigo_tpu_torch import interop, presets as tpresets, rlwe as trlwe
from lattigo_tpu_torch.rlwe.params import gen_moduli as t_gen_moduli
from lattigo_tpu_torch.schemes import ckks as tckks

LOG_N, LOG_Q, LOG_P, LOG_SCALE = 12, (28,) * 5, (28, 28), 28
BATCH = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here, and
    they crowd the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _literal(mod):
    return mod.ParametersLiteral(log_n=LOG_N, log_q=LOG_Q, log_p=LOG_P,
                                 log_default_scale=LOG_SCALE)


def _slots(rng, shape, bound=1.0):
    return bound * (rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape))


# op name -> f(evaluator, ct_a, ct_b, pt_b, pt_b at scale 2^29); each runs
# on both packages' objects
OPS = {
    "add_ct": lambda ev, a, b, pb, pb2: ev.add(a, b),
    "sub_ct": lambda ev, a, b, pb, pb2: ev.sub(a, b),
    "neg": lambda ev, a, b, pb, pb2: ev.neg(a),
    "add_pt": lambda ev, a, b, pb, pb2: ev.add(a, pb),
    "sub_pt": lambda ev, a, b, pb, pb2: ev.sub(a, pb),
    "add_pt_other_scale": lambda ev, a, b, pb, pb2: ev.add(a, pb2),
    "add_const_real": lambda ev, a, b, pb, pb2: ev.add(a, 0.375),
    "add_const_complex": lambda ev, a, b, pb, pb2: ev.add(a, 0.5 - 0.25j),
    "sub_const_complex": lambda ev, a, b, pb, pb2: ev.sub(a, -0.125 + 0.75j),
    "mul_scalar_int": lambda ev, a, b, pb, pb2: ev.mul_scalar_int(a, -3),
    "scale_up": lambda ev, a, b, pb, pb2: ev.scale_up(a, 8),
    "set_scale": lambda ev, a, b, pb, pb2: ev.set_scale(a, Fraction(2) ** 29),
    "mul_const_real": lambda ev, a, b, pb, pb2: ev.mul_const(a, -0.7),
    "mul_const_complex": lambda ev, a, b, pb, pb2: ev.mul_const(a, 0.7 - 1.3j),
    "mul_by_i": lambda ev, a, b, pb, pb2: ev.mul_by_i(a),
    "mul_by_minus_i": lambda ev, a, b, pb, pb2: ev.mul_by_minus_i(a),
    "mul_pt_rescale": lambda ev, a, b, pb, pb2: ev.rescale(ev.mul(a, pb)),
    "mul": lambda ev, a, b, pb, pb2: ev.mul(a, b),
    "mul_relin": lambda ev, a, b, pb, pb2: ev.mul_relin(a, b),
    "mul_relin_rescale": lambda ev, a, b, pb, pb2: ev.rescale(ev.mul_relin(a, b)),
    "mul_relin_then_add": lambda ev, a, b, pb, pb2: ev.mul_relin_then_add(
        a, b, ev.mul_relin(b, b)),
    "mul_then_add": lambda ev, a, b, pb, pb2: ev.mul_then_add(a, pb, ev.mul(b, pb)),
    # ratio 2^28: the smaller-scale operand is multiplied up
    "add_scale_ratio": lambda ev, a, b, pb, pb2: ev.add(a, ev.mul_relin(a, b)),
    # ratio ~1 after a rescale by a 28-bit prime: rounded, then relabelled
    "add_after_rescale": lambda ev, a, b, pb, pb2: ev.add(
        ev.rescale(ev.mul_relin(a, b)), ev.drop_level(a)),
    "rescale_to": lambda ev, a, b, pb, pb2: ev.rescale_to(
        ev.mul(ev.mul_relin(a, b), pb), Fraction(2) ** 40),
}


@pytest.fixture(scope="module")
def ref():
    pj = jckks.Parameters(_literal(jckks))
    pt = tckks.Parameters(_literal(tckks), device="cpu")
    encj, pencj = jckks.Encoder(pj), jckks.PrecisionEncoder(pj)
    rng = np.random.default_rng(21)
    va = _slots(rng, (BATCH, pj.max_slots))
    vb = _slots(rng, (BATCH, pj.max_slots))
    vp = _slots(rng, (pj.max_slots,))
    kg = jrlwe.KeyGenerator(pj)
    scales = {}

    def setup(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        sk = kg.gen_secret_key(k1)
        rlk = kg.gen_relinearization_key(k2, sk)
        enc = jrlwe.Encryptor(pj, sk)
        pa, pb = encj.encode(va), encj.encode(vb)
        pb2 = encj.encode(vb, scale=Fraction(2) ** 29)
        pp = pencj.encode(vp, level=3, scale=Fraction(2) ** 40)
        ca = enc.encrypt(k3, pa, batch=(BATCH,))
        cb = enc.encrypt(k4, pb, batch=(BATCH,))
        ev = jckks.Evaluator(pj, jrlwe.EvaluationKeySet(rlk))
        out = {}
        for name, op in OPS.items():
            r = op(ev, ca, cb, pb, pb2)
            out[name] = r.value
            scales[name] = Fraction(r.scale)
        dec = jrlwe.Decryptor(pj, sk).decrypt(jrlwe.Ciphertext(
            value=out["mul_relin_rescale"], scale=scales["mul_relin_rescale"]))
        return dict(out, sk_q=sk.value.q, sk_p=sk.value.p,
                    rlk_q=rlk.gadget.value.q, rlk_p=rlk.gadget.value.p,
                    pa=pa.value, pb=pb.value, pb2=pb2.value, pp=pp.value,
                    ca=ca.value, cb=cb.value,
                    dec_coeffs=pj.ring_q.intt(dec.value, dec.level),
                    pa_coeffs=pj.ring_q.intt(pa.value),
                    pp_coeffs=pj.ring_q.intt(pp.value, 3))

    arrays = jax.jit(setup)(jax.random.PRNGKey(4))
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    return dict(pj=pj, pt=pt, encj=encj, pencj=pencj, va=va, vb=vb, vp=vp,
                arrays=arrays, scales=scales)


def test_moduli_and_scales(ref):
    pj, pt = ref["pj"], ref["pt"]
    assert pt.q_moduli == pj.q_moduli and pt.p_moduli == pj.p_moduli
    assert pt.default_scale_fraction == pj.default_scale_fraction == 2 ** 28
    assert (pt.max_slots, pt.log_max_slots) == (pj.max_slots, pj.log_max_slots)
    assert all(pt.q_fraction(i) == pj.q_fraction(i) for i in range(pt.max_level + 1))
    # the slice's configuration: logN=14, 13 + 2 primes < 2^29, scale 2^28
    jl, tl = jpresets.ckks_tpu_params(14, 438), tpresets.ckks_tpu_params(14, 438)
    assert ((tl.log_q, tl.log_p, tl.log_default_scale)
            == (jl.log_q, jl.log_p, jl.log_default_scale))
    q, p = t_gen_moduli(14, 2 << 14, tl.log_q, tl.log_p)
    assert (q, p) == j_gen_moduli(14, 2 << 14, jl.log_q, jl.log_p)
    assert len(q) == 13 and len(p) == 2 and max(q + p) < (1 << 29)
    for jlit, tlit in zip(jpresets.CKKS_COMPLEX_PARAMS, tpresets.CKKS_COMPLEX_PARAMS):
        assert ((tlit.log_n, tlit.log_q, tlit.log_p, tlit.log_default_scale)
                == (jlit.log_n, jlit.log_q, jlit.log_p, jlit.log_default_scale))


def test_engines(ref):
    for ring in (ref["pt"].ring_q, ref["pt"].ring_p):
        assert ring.ntt_engine == "mxu-plain"


def test_encoder_parity(ref):
    pt, a, encj = ref["pt"], ref["arrays"], ref["encj"]
    enc = tckks.Encoder(pt)
    np.testing.assert_array_equal(interop.to_numpy(enc.encode(ref["va"]).value), a["pa"])
    got = enc.encode(ref["vb"], scale=Fraction(2) ** 29)
    assert got.scale == Fraction(2) ** 29
    np.testing.assert_array_equal(interop.to_numpy(got.value), a["pb2"])
    # decode: the port's batched decode of the NTT plaintext against the JAX
    # package's decode of each polynomial of its INTT
    pts = interop.plaintext_from_numpy(a["pa"], "cpu", scale=pt.default_scale_fraction)
    have = enc.decode(pts)
    coeffs = a["pa_coeffs"]
    for i in range(BATCH):
        want = encj.decode(jrlwe.Plaintext(value=coeffs[i], is_ntt=False,
                                           scale=pts.scale))
        np.testing.assert_allclose(have[i], want, rtol=2.0 ** -40, atol=0)
        np.testing.assert_allclose(
            enc.decode_public(pts, log_prec=12)[i],
            encj.decode_public(jrlwe.Plaintext(value=coeffs[i], is_ntt=False,
                                               scale=pts.scale), log_prec=12),
            rtol=2.0 ** -40, atol=0)


def test_encoder_decode_of_product(ref):
    """Decoded floats of the same integers agree: rescale(mul_relin) as the
    JAX package's key decrypts it."""
    pt, a, encj = ref["pt"], ref["arrays"], ref["encj"]
    scale = ref["scales"]["mul_relin_rescale"]
    sk = interop.secret_key_from_numpy(a["sk_q"], a["sk_p"], "cpu")
    ct = interop.ciphertext_from_numpy(a["mul_relin_rescale"], "cpu", scale=scale)
    have = tckks.Encoder(pt).decode(trlwe.Decryptor(pt, sk).decrypt(ct))
    for i in range(BATCH):
        want = encj.decode(jrlwe.Plaintext(value=a["dec_coeffs"][i], is_ntt=False,
                                           scale=scale))
        np.testing.assert_allclose(have[i], want, rtol=2.0 ** -40, atol=0)
    tckks.verify_test_vectors(ref["va"] * ref["vb"], have, 13.0)


def test_precision_encoder_parity(ref):
    pt, a = ref["pt"], ref["arrays"]
    enc = tckks.PrecisionEncoder(pt)
    got = enc.encode(ref["vp"], level=3, scale=Fraction(2) ** 40)
    np.testing.assert_array_equal(interop.to_numpy(got.value), a["pp"])
    hi, lo = enc.decode_dd(got)
    jhi, jlo = ref["pencj"].decode_dd(jrlwe.Plaintext(
        value=a["pp_coeffs"], is_ntt=False, scale=Fraction(2) ** 40))
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(lo, jlo)
    assert np.abs(hi + lo - ref["vp"]).max() < 2.0 ** -30


@pytest.mark.parametrize("name", list(OPS))
def test_op_bit_equal(ref, name):
    pt, a = ref["pt"], ref["arrays"]
    rlk = interop.relinearization_key_from_numpy(a["rlk_q"], a["rlk_p"], "cpu")
    ev = tckks.Evaluator(pt, trlwe.EvaluationKeySet(rlk))
    s = pt.default_scale_fraction
    ca = interop.ciphertext_from_numpy(a["ca"], "cpu", scale=s)
    cb = interop.ciphertext_from_numpy(a["cb"], "cpu", scale=s)
    pb = interop.plaintext_from_numpy(a["pb"], "cpu", scale=s)
    pb2 = interop.plaintext_from_numpy(a["pb2"], "cpu", scale=Fraction(2) ** 29)
    out = OPS[name](ev, ca, cb, pb, pb2)
    assert isinstance(out.scale, Fraction) and out.scale == ref["scales"][name]
    np.testing.assert_array_equal(interop.to_numpy(out.value), a[name])


# -- the port's own keys, at tests/test_ckks.py's parameters and floors ---------

@pytest.fixture(scope="module")
def own():
    params = tckks.Parameters(tckks.ParametersLiteral(
        log_n=11, log_q=(50, 40, 40, 40), log_p=(55,), log_default_scale=40),
        device="cpu")
    gen = torch.Generator().manual_seed(7)
    kg = trlwe.KeyGenerator(params)
    sk = kg.gen_secret_key(gen)
    rlk = kg.gen_relinearization_key(gen, sk)
    enc = tckks.Encoder(params)
    encryptor = trlwe.Encryptor(params, sk)
    rng = np.random.default_rng(8)
    v1, v2 = (_slots(rng, (params.max_slots,)) for _ in range(2))
    return dict(params=params, sk=sk, enc=enc, v1=v1, v2=v2,
                c1=encryptor.encrypt(gen, enc.encode(v1)),
                c2=encryptor.encrypt(gen, enc.encode(v2)),
                ev=tckks.Evaluator(params, trlwe.EvaluationKeySet(rlk)),
                dec=lambda ct: enc.decode(trlwe.Decryptor(params, sk).decrypt(ct)))


def test_own_keys_encode_encrypt(own):
    enc, v1 = own["enc"], own["v1"]
    tckks.verify_test_vectors(v1, enc.decode(enc.encode(v1)), 35.0)
    tckks.verify_test_vectors(v1, own["dec"](own["c1"]), 30.0)


@pytest.mark.parametrize("case, floor", [
    ("add", 30.0), ("add_const", 30.0), ("mul_relin_rescale", 25.0),
    ("mul_const_complex", 25.0), ("mul_by_i", 30.0)])
def test_own_keys_precision(own, case, floor):
    ev, c1, c2, v1, v2 = own["ev"], own["c1"], own["c2"], own["v1"], own["v2"]
    c = 0.7 - 1.3j
    ct, want = {
        "add": lambda: (ev.add(c1, c2), v1 + v2),
        "add_const": lambda: (ev.add(c1, 0.5 - 0.25j), v1 + (0.5 - 0.25j)),
        "mul_relin_rescale": lambda: (ev.rescale(ev.mul_relin(c1, c2)), v1 * v2),
        "mul_const_complex": lambda: (ev.rescale(ev.mul_const(c1, c)), v1 * c),
        "mul_by_i": lambda: (ev.mul_by_i(c1), 1j * v1),
    }[case]()
    tckks.verify_test_vectors(want, own["dec"](ct), floor)
