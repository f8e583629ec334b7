"""Port parity for the rest of BGV/BFV and the exact BGV polynomials.

At ``tests/test_bfv.py``'s parameters (logN 10, Q (45, 38, 38), P 50,
T = 65537) the JAX package, under one ``jax.jit``, runs ``neg``,
``mul_scalar``, ``mul_then_add``, ``mul_relin_then_add``, ``drop_level``
and BFV's ``mul_scale_invariant`` (depth 2, with and without
relinearization) on the port's relinearization key and ciphertexts,
carried over as numpy; the port must give the same residues (tolerance
0), levels and T-scales, and its outputs decrypt to numpy's answer mod T.
The QMul primes equal the reference's. The Lagrange interpolation over
Z_T is equal; and at ``tests/test_bgv_polynomial.py``'s parameters (logN
9) a degree-7 and a degree-15 ``BGVPolynomialEvaluator.evaluate`` are
bit-equal and exact.
"""

import numpy as np
import jax
import pytest
import torch

from lattigo_tpu import rlwe as jrlwe
from lattigo_tpu.circuits import bgv_polynomial as jbpoly
from lattigo_tpu.ring.ringqp import QPPoly as JQPPoly
from lattigo_tpu.schemes import bgv as jbgv
from lattigo_tpu.utils.primes import NTTFriendlyPrimesGenerator as JGen
from lattigo_tpu_torch import interop, presets as tpresets, rlwe as trlwe
from lattigo_tpu_torch.circuits import bgv_polynomial as tbpoly
from lattigo_tpu_torch.schemes import bgv as tbgv

LIT_BFV = dict(log_n=10, log_q=(45, 38, 38), log_p=(50,), t=65537)
LIT_POLY = dict(log_n=9, log_q=(45,) + (40,) * 6, log_p=(50,), t=65537)
BATCH = 2
SCALAR = 40000
POLY7 = [12, 7, 0, 3, 0, 0, 1, 9]
POLY15 = [0] + [int(c) for c in np.random.default_rng(31).integers(0, 65537, 15)]

# XLA's CPU backend at its lowest optimisation level: these programs are
# integer-exact, so it changes no result, and they compile several times
# faster
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(lit):
    return (jbgv.Parameters(jbgv.ParametersLiteral(**lit)),
            tbgv.Parameters(tbgv.ParametersLiteral(**lit), device="cpu"))


def _carry(pj, pt, ops, slots, seed):
    """The port's keys and BATCH ciphertexts of each slot vector, carried
    to the JAX package as numpy; ``ops(module, ev, cts)`` evaluated by the
    JAX package under one jit and by the port. Returns the JAX outputs,
    their (level, scale), the port's outputs and the secret key."""
    gen = torch.Generator().manual_seed(seed)
    kg = trlwe.KeyGenerator(pt)
    sk = kg.gen_secret_key(gen)
    rlk = kg.gen_relinearization_key(gen, sk)
    enc, encryptor = tbgv.Encoder(pt), trlwe.Encryptor(pt, sk)
    cts = [encryptor.encrypt(gen, enc.encode(v), batch=(BATCH,)) for v in slots]
    rlk_np = interop.qp_to_numpy(rlk.gadget.value)
    cts_np = [interop.to_numpy(c.value) for c in cts]
    meta = {}

    def run(rlk_qp, cvals):
        ev = jbgv.Evaluator(pj, jrlwe.EvaluationKeySet(jrlwe.RelinearizationKey(
            jrlwe.GadgetCiphertext(JQPPoly(*rlk_qp)))))
        outs = ops(jbpoly, ev, [jrlwe.Ciphertext(value=c, scale=1) for c in cvals])
        for k, o in outs.items():
            meta[k] = (o.level, o.scale)
        return {k: o.value for k, o in outs.items()}

    ref = jax.jit(run, compiler_options=_FAST_COMPILE)(rlk_np, cts_np)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    port = ops(tbpoly, tbgv.Evaluator(pt, trlwe.EvaluationKeySet(rlk)), cts)
    return ref, meta, port, sk


def _bfv_ops(_, ev, cts):
    c1, c2 = cts
    msi = ev.mul_scale_invariant(c1, c2, relin=True)
    return {
        "neg": ev.neg(c1),
        "mul_scalar": ev.mul_scalar(c1, SCALAR),
        "mul_then_add": ev.mul_then_add(c1, c2, ev.mul_scalar(c2, 3)),
        "mul_relin_then_add": ev.mul_relin_then_add(c1, c2, c1),
        "drop_level": ev.drop_level(c2, 2),
        "msi": msi,
        "msi2": ev.mul_scale_invariant(msi, c1, relin=True),
        "msi_degree2": ev.mul_scale_invariant(c1, c2),
    }


def _poly_ops(mod, ev, cts):
    pe = mod.BGVPolynomialEvaluator(ev)
    return {"poly7": pe.evaluate(cts[0], POLY7), "poly15": pe.evaluate(cts[0], POLY15)}


@pytest.fixture(scope="module")
def bfv():
    pj, pt = _params(LIT_BFV)
    rng = np.random.default_rng(4)
    m = [rng.integers(0, pt.t, (BATCH, pt.n)) for _ in range(2)]
    ref, meta, port, sk = _carry(pj, pt, _bfv_ops, m, seed=7)
    return dict(pj=pj, pt=pt, m=m, arrays=ref, meta=meta, port=port, sk=sk)


@pytest.fixture(scope="module")
def poly():
    pj, pt = _params(LIT_POLY)
    m = np.random.default_rng(9).integers(0, pt.t, (BATCH, pt.n))
    ref, meta, port, sk = _carry(pj, pt, _poly_ops, [m], seed=8)
    return dict(pj=pj, pt=pt, m=m, arrays=ref, meta=meta, port=port, sk=sk)


def test_ring_qmul_primes_equal(bfv):
    pj, pt = bfv["pj"], bfv["pt"]
    assert pt.ring_qmul.moduli == pj.ring_qmul.moduli
    # half of QMul's 61-bit primes lie just above 2^61, off the u64
    # four-step engine's q < 2^61 (the reference's rule too): radix-2
    assert max(pt.ring_qmul.moduli) >= 1 << 61
    assert pt.ring_qmul.ntt_engine == "radix2-plain"
    # the card's configuration: 13 primes of 61 bits, off Q's and T
    lit = tpresets.bgv_tpu_params(14, 438)
    p14 = tbgv.Parameters(lit, device="cpu")
    gen, want = JGen(61, 2 << 14), []
    while len(want) < len(p14.q_moduli):
        c = gen.next_alternating_prime()
        if c not in p14.q_moduli and c != p14.t:
            want.append(c)
    assert [s.modulus for s in p14.ring_qmul.subrings] == want


BFV_OPS = ["neg", "mul_scalar", "mul_then_add", "mul_relin_then_add", "drop_level",
           "msi", "msi2", "msi_degree2"]


@pytest.mark.parametrize("name", BFV_OPS)
def test_bfv_ops_bit_equal(bfv, name):
    """Tolerance 0 on the residues; equal level and T-scale."""
    got = bfv["port"][name]
    assert (got.level, got.scale) == bfv["meta"][name]
    np.testing.assert_array_equal(interop.to_numpy(got.value), bfv["arrays"][name])


def test_bfv_ops_decrypt(bfv):
    """The port's outputs, decrypted with the carried key, against numpy."""
    pt, (m1, m2) = bfv["pt"], bfv["m"]
    t = pt.t
    enc, dec = tbgv.Encoder(pt), trlwe.Decryptor(pt, bfv["sk"])
    o1, o2 = m1.astype(object), m2.astype(object)
    want = {
        "neg": -o1, "mul_scalar": o1 * SCALAR, "mul_then_add": o1 * o2 + 3 * o2,
        "mul_relin_then_add": o1 * o2 + o1, "drop_level": o2, "msi": o1 * o2,
        "msi2": o1 * o2 * o1, "msi_degree2": o1 * o2,
    }
    for name, w in want.items():
        got = enc.decode(dec.decrypt(bfv["port"][name]))
        np.testing.assert_array_equal(np.asarray(got) % t, (w % t).astype(np.int64),
                                      err_msg=name)
    assert bfv["port"]["msi2"].level == bfv["port"]["msi"].level == pt.max_level


def test_interpolation_equal():
    t = 65537
    p = [3, 5, 0, 7]
    xs = [1, 2, 3, 4, 9]
    ys = [sum(c * pow(x, i, t) for i, c in enumerate(p)) % t for x in xs]
    assert tbpoly.interpolate_mod_t(xs, ys, t) == jbpoly.interpolate_mod_t(xs, ys, t) \
        == [3, 5, 0, 7, 0]
    for fn in (lambda x: x ** 3 + 2, lambda x: 1 if x > 48 else 0):
        want = jbpoly.function_mod_t(fn, 97)
        got = tbpoly.function_mod_t(fn, 97)
        assert got == want
        assert all(sum(c * pow(x, i, 97) for i, c in enumerate(got)) % 97 == fn(x) % 97
                   for x in range(97))


@pytest.mark.parametrize("name", ["poly7", "poly15"])
def test_bgv_polynomial_bit_equal(poly, name):
    got = poly["port"][name]
    assert (got.level, got.scale) == poly["meta"][name]
    np.testing.assert_array_equal(interop.to_numpy(got.value), poly["arrays"][name])


def test_bgv_polynomial_exact(poly):
    pt, m = poly["pt"], poly["m"]
    t = pt.t
    enc, dec = tbgv.Encoder(pt), trlwe.Decryptor(pt, poly["sk"])
    for name, coeffs in (("poly7", POLY7), ("poly15", POLY15)):
        want = np.zeros(m.shape, dtype=object)
        for c in coeffs[::-1]:
            want = (want * m.astype(object) + c) % t
        got = enc.decode(dec.decrypt(poly["port"][name]))
        np.testing.assert_array_equal(np.asarray(got) % t, want.astype(np.int64),
                                      err_msg=name)
