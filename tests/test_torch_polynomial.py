"""Port parity for polynomial evaluation and EvalMod.

Host tables first, with tolerance 0: the Han–Ki cosine coefficients
(``approximate_cos``, 256-bit mpmath values compared exactly), Chebyshev
interpolation, ``optimal_split``, ``factorize`` in both bases, the
metadata-only ``simulate``'s levels and scales, and ``Mod1Evaluator``'s
polynomial coefficients and DC bias for every mod-1 type. Then, at logN 6
on a chain of eight 50-bit primes, the JAX package (under one ``jax.jit`` for the
keys and inputs and one for the evaluations) evaluates a Chebyshev and a
monomial polynomial and a COS_CONTINUOUS EvalMod with a pinned working
scale; the port, on the carried relinearization key and ciphertexts, must
give the same residues (tolerance 0), the same exact ``Fraction`` scales
and the same levels; the decrypted results are also held against numpy.
"""

from fractions import Fraction

import numpy as np
import jax
import pytest
import torch

from lattigo_tpu import rlwe as jrlwe
from lattigo_tpu.circuits import mod1 as jmod1, polynomial as jpoly
from lattigo_tpu.ring.ringqp import QPPoly as JQPPoly
from lattigo_tpu.schemes import ckks as jckks
from lattigo_tpu.utils import cosine as jcos
from lattigo_tpu_torch import interop, rlwe as trlwe
from lattigo_tpu_torch.circuits import mod1 as tmod1, polynomial as tpoly
from lattigo_tpu_torch.schemes import ckks as tckks
from lattigo_tpu_torch.utils import cosine as tcos

LIT = dict(log_n=6, log_q=(55,) + (50,) * 7, log_p=(60, 60),
           log_default_scale=50)

COS_CASES = [(16, 30, 256.0, 3), (12, 24, 256.0, 2), (16, 30, 4.0, 3),
             (4, 14, 64.0, 1)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's ops here act on small tensors, where torch's intra-op
    threads only add overhead: one thread runs this file faster and leaves
    the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Stub:
    """Stands in for an evaluator where only ``params`` is read."""

    def __init__(self, params):
        self.params = params


MOD1_CASES = {
    "cos_discrete_debias": dict(k=16, degree=30, double_angle=3,
                                log_message_ratio=8, mod1_type="cos_discrete",
                                log_scale=50, debias_weight=32),
    "cos_discrete_arcsine": dict(k=16, degree=30, double_angle=3,
                                 log_message_ratio=2, arcsine_degree=7,
                                 mod1_type="cos_discrete", log_scale=50,
                                 debias_weight=32),
    "cos_continuous": dict(k=8, degree=40, double_angle=3,
                           mod1_type="cos_continuous"),
    "sin_continuous": dict(k=2, degree=31, mod1_type="sin_continuous"),
    "cos_discrete_dense": dict(k=16, degree=30, double_angle=3,
                               log_message_ratio=8, mod1_type="cos_discrete",
                               debias_weight=96),
}


@pytest.mark.parametrize("case", COS_CASES)
def test_approximate_cos_equal(case):
    want = jcos.approximate_cos(*case)
    have = tcos.approximate_cos(*case)
    assert len(have) == len(want)
    assert all(h == w for h, w in zip(have, want))     # exact mpf values
    deg = jcos._gen_degrees(case[1], case[0], case[2])
    assert tcos._gen_degrees(case[1], case[0], case[2]) == deg


@pytest.mark.parametrize("degree", [7, 15, 30, 63])
def test_chebyshev_approximate_equal(degree):
    fns = [np.sin, lambda x: np.exp(-x * x) + 0.25j * x, np.cos]
    for fn, interval in zip(fns, [(-1.0, 1.0), (-3.0, 2.0), (0.0, 8.0)]):
        w = jpoly.chebyshev_approximate(fn, degree, interval)
        h = tpoly.chebyshev_approximate(fn, degree, interval)
        np.testing.assert_array_equal(np.array(h.coeffs), np.array(w.coeffs))
        assert (h.basis, h.interval) == (w.basis, w.interval)


def test_optimal_split_equal():
    for d in range(1, 20):
        assert tpoly.optimal_split(d) == jpoly.optimal_split(d)


@pytest.mark.parametrize("basis", ["monomial", "chebyshev"])
def test_factorize_equal(basis):
    rng = np.random.default_rng(3)
    coeffs = list(rng.uniform(-1, 1, 32) + 1j * rng.uniform(-1, 1, 32))
    for n in (16, 20, 24, 31, 32, 40):   # P-S splits: n ≥ (degree + 1)/2
        hq, hr = tpoly.Polynomial(coeffs, basis).factorize(n)
        wq, wr = jpoly.Polynomial(coeffs, basis).factorize(n)
        np.testing.assert_array_equal(np.array(hq.coeffs), np.array(wq.coeffs))
        np.testing.assert_array_equal(np.array(hr.coeffs), np.array(wr.coeffs))


@pytest.fixture(scope="module")
def params():
    return (jckks.Parameters(jckks.ParametersLiteral(**LIT)),
            tckks.Parameters(tckks.ParametersLiteral(**LIT), device="cpu"))


def test_simulate_equal(params):
    pj, pt = params
    assert pt.q_moduli == pj.q_moduli and pt.p_moduli == pj.p_moduli
    rng = np.random.default_rng(5)
    for degree, basis in [(7, "monomial"), (15, "chebyshev"), (30, "chebyshev"),
                          (31, "chebyshev"), (63, "chebyshev"), (5, "monomial")]:
        c = list(rng.uniform(-1, 1, degree + 1))
        for level, scale, target in [(7, Fraction(2) ** 50, None),
                                     (7, Fraction(pj.q_moduli[7]), Fraction(2) ** 45),
                                     (6, Fraction(3, 7) * 2 ** 52, Fraction(2) ** 50)]:
            w = jpoly.simulate(pj, level, scale, jpoly.Polynomial(c, basis), target)
            h = tpoly.simulate(pt, level, scale, tpoly.Polynomial(c, basis), target)
            assert (h.level, h.scale) == (w.level, w.scale)


@pytest.mark.parametrize("name", list(MOD1_CASES))
def test_mod1_polynomial_equal(params, name):
    pj, pt = params
    kw = MOD1_CASES[name]
    w = jmod1.Mod1Evaluator(_Stub(pj), jmod1.Mod1Parameters(**kw))
    h = tmod1.Mod1Evaluator(_Stub(pt), tmod1.Mod1Parameters(**kw))
    assert h._poly.basis == w._poly.basis and h._poly.interval == w._poly.interval
    assert len(h._poly.coeffs) == len(w._poly.coeffs)
    for a, b in zip(h._poly.coeffs, w._poly.coeffs):
        assert type(a) is type(b) and a == b
    assert h._dc_bias == w._dc_bias
    assert (h._r, h._sqrt2pi) == (w._r, w._sqrt2pi)


# -- homomorphic evaluation on carried ciphertexts ---------------------------

CHEB = tpoly.chebyshev_approximate(lambda x: np.sin(2 * x) + 0.5j * x * x, 7)
MONO = [0.5, -1.25 + 0.5j, 0.75, 0.0, -0.3, 0.2j]
EVALMOD = dict(k=2, degree=12, double_angle=2, mod1_type="cos_continuous",
               log_scale=50)


def _evaluations(poly_mod, mod1_mod, ev, ct_poly, ct_mod):
    pe = poly_mod.PolynomialEvaluator(ev)
    me = mod1_mod.Mod1Evaluator(ev, mod1_mod.Mod1Parameters(**EVALMOD))
    return {
        "chebyshev": pe.evaluate(ct_poly, poly_mod.Polynomial(
            CHEB.coeffs, "chebyshev")),
        "monomial": pe.evaluate(ct_poly, poly_mod.Polynomial(MONO, "monomial"),
                                Fraction(2) ** 45),
        "evalmod": me.evaluate(ct_mod),
    }


@pytest.fixture(scope="module")
def ref(params):
    pj, _ = params
    rng = np.random.default_rng(11)
    slots = pj.max_slots
    v_poly = rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots)
    ints = rng.integers(-1, 2, slots)          # |y| < K = 2
    v_mod = ints + rng.uniform(-2.0 ** -6, 2.0 ** -6, slots)
    kg = jrlwe.KeyGenerator(pj)
    enc = jckks.Encoder(pj)

    def setup(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        sk = kg.gen_secret_key(k1)
        rlk = kg.gen_relinearization_key(k2, sk)
        e = jrlwe.Encryptor(pj, sk)
        return dict(sk_q=sk.value.q, sk_p=sk.value.p,
                    rlk_q=rlk.gadget.value.q, rlk_p=rlk.gadget.value.p,
                    ct_poly=e.encrypt(k3, enc.encode(v_poly)).value,
                    ct_mod=e.encrypt(k4, enc.encode(v_mod)).value)

    a = {k: np.asarray(v) for k, v in jax.jit(setup)(jax.random.PRNGKey(2)).items()}
    meta = {}
    scale = pj.default_scale_fraction

    def run(rlk_q, rlk_p, c_poly, c_mod):
        ev = jckks.Evaluator(pj, jrlwe.EvaluationKeySet(jrlwe.RelinearizationKey(
            jrlwe.GadgetCiphertext(JQPPoly(rlk_q, rlk_p)))))
        outs = _evaluations(jpoly, jmod1, ev,
                            jrlwe.Ciphertext(value=c_poly, scale=scale),
                            jrlwe.Ciphertext(value=c_mod, scale=scale))
        for k, o in outs.items():
            meta[k] = (o.level, Fraction(o.scale))
        return {k: o.value for k, o in outs.items()}

    out = jax.jit(run)(a["rlk_q"], a["rlk_p"], a["ct_poly"], a["ct_mod"])
    a.update({k: np.asarray(v) for k, v in out.items()})
    return dict(arrays=a, meta=meta, v_poly=v_poly, v_mod=v_mod, ints=ints)


@pytest.fixture(scope="module")
def port(params, ref):
    _, pt = params
    a = ref["arrays"]
    rlk = interop.relinearization_key_from_numpy(a["rlk_q"], a["rlk_p"], "cpu")
    ev = tckks.Evaluator(pt, trlwe.EvaluationKeySet(rlk))
    scale = pt.default_scale_fraction
    return _evaluations(
        tpoly, tmod1, ev,
        interop.ciphertext_from_numpy(a["ct_poly"], "cpu", scale=scale),
        interop.ciphertext_from_numpy(a["ct_mod"], "cpu", scale=scale))


@pytest.mark.parametrize("name", ["chebyshev", "monomial", "evalmod"])
def test_evaluation_bit_equal(ref, port, name):
    """Tolerance 0 on the residues; equal level and exact scale."""
    got = port[name]
    assert (got.level, Fraction(got.scale)) == ref["meta"][name]
    np.testing.assert_array_equal(interop.to_numpy(got.value), ref["arrays"][name])


def test_evaluation_decrypts(params, ref, port):
    """The port's outputs, decrypted with the carried key, against numpy:
    P(x) within 2^-20 and EvalMod's y mod 1 within 2^-12 (sin(2πy)/2π, what
    EvalMod computes, departs from y mod 1 by ≤ 2^-15 at |y mod 1| ≤ 2^-6)."""
    _, pt = params
    a = ref["arrays"]
    sk = interop.secret_key_from_numpy(a["sk_q"], a["sk_p"], "cpu")
    enc, dec = tckks.Encoder(pt), trlwe.Decryptor(pt, sk)
    x = ref["v_poly"]
    want = {
        "chebyshev": tpoly.PolynomialVector([CHEB], {0: list(range(len(x)))})
        .evaluate_plain(x),
        "monomial": np.polyval(MONO[::-1], x),
        "evalmod": ref["v_mod"] - ref["ints"],
    }
    tol = {"chebyshev": 2.0 ** -20, "monomial": 2.0 ** -20, "evalmod": 2.0 ** -12}
    for name, w in want.items():
        got = enc.decode(dec.decrypt(port[name]))
        err = np.abs(got - w).max()
        assert err < tol[name], f"{name}: max error 2^{np.log2(err):.1f}"


def test_polynomial_vector_decrypts(params, ref):
    """A PolynomialVector (a different polynomial on each half of the
    slots, encoded coefficient vectors) on the carried ciphertext: each
    slot within 2^-20 of its own polynomial, and no fold of the scale."""
    _, pt = params
    a = ref["arrays"]
    rlk = interop.relinearization_key_from_numpy(a["rlk_q"], a["rlk_p"], "cpu")
    sk = interop.secret_key_from_numpy(a["sk_q"], a["sk_p"], "cpu")
    enc = tckks.Encoder(pt)
    ev = tckks.Evaluator(pt, trlwe.EvaluationKeySet(rlk))
    half = pt.max_slots // 2
    vec = tpoly.PolynomialVector(
        [tpoly.Polynomial(CHEB.coeffs, "chebyshev"),
         tpoly.Polynomial([0.25, 0.0, -1.5, 0.5j, 0.75, 0, 0, 0.125], "chebyshev")],
        {0: list(range(half)), 1: list(range(half, pt.max_slots))})
    ct = interop.ciphertext_from_numpy(a["ct_poly"], "cpu",
                                       scale=pt.default_scale_fraction)
    out = tpoly.PolynomialEvaluator(ev, enc).evaluate(ct, vec)
    assert out.scale == pt.default_scale_fraction
    assert out.level == ct.level - vec.degree.bit_length()
    got = enc.decode(trlwe.Decryptor(pt, sk).decrypt(out))
    err = np.abs(got - vec.evaluate_plain(ref["v_poly"])).max()
    assert err < 2.0 ** -20, f"max error 2^{np.log2(err):.1f}"
    with pytest.raises(ValueError, match="encoder"):
        tpoly.PolynomialEvaluator(ev).evaluate(ct, vec)
