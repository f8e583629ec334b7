"""Port parity for the power-of-two gadget and P-less key switching.

The cases of ``tests/test_base2_gadget.py`` on the port (a single P and no
P at w = 14 and 15: an evaluation key re-encrypts exactly, BGV mul_relin
with a base-2 relinearization key stays exact), ``_gadget_scalars_base2``
equal to the JAX package's, and ``gadget_product_base2`` bit-equal to the
JAX package's (under one ``jax.jit``) on the port's key and ciphertext:
at logN 9 with and without P, and at the edge of the port's int64 sums:
primes just below 2^60 and 14 rows, where the row sum passes 2^63 but not
2^64 (the JAX package's u64 sum is exact), and primes just above 2^60 and
32 rows, where it passes 2^64 and only the port's Barrett folds keep the
residue exact. Tolerance 0.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lattigo_tpu import rlwe as jrlwe
from lattigo_tpu.ring.ringqp import QPPoly as JQPPoly
from lattigo_tpu.schemes import bgv as jbgv
from lattigo_tpu_torch import interop, rlwe
from lattigo_tpu_torch.ring import modops
from lattigo_tpu_torch.schemes import bgv
from lattigo_tpu_torch.utils.primes import NTTFriendlyPrimesGenerator

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lit(log_p, log_q=(45, 38), log_n=9):
    return dict(log_n=log_n, log_q=log_q, log_p=log_p or None, t=65537)


@pytest.mark.parametrize("w", [14, 15])
@pytest.mark.parametrize("log_p", [(50,), ()], ids=["single-P", "no-P"])
def test_base2_key_switch(log_p, w):
    """An evaluation key with a base-2^w gadget re-encrypts exactly."""
    params = bgv.Parameters(bgv.ParametersLiteral(**lit(log_p)), device="cpu")
    kg = rlwe.KeyGenerator(params)
    gen = torch.Generator().manual_seed(w)
    sk, sk2 = kg.gen_secret_key(gen), kg.gen_secret_key(gen)
    evk = kg.gen_evaluation_key(gen, sk, sk2, base2=w)
    assert evk.gadget.base2 == w and (evk.gadget.value.p is None) == (not log_p)
    enc = bgv.Encoder(params)
    m = np.random.default_rng(5).integers(0, params.t, params.n)
    ct = rlwe.Encryptor(params, sk).encrypt(gen, enc.encode(m))
    sw = rlwe.Evaluator(params).apply_evaluation_key(ct, evk)
    got = enc.decode(rlwe.Decryptor(params, sk2).decrypt(sw))
    np.testing.assert_array_equal(got, m)


@pytest.mark.parametrize("w", [14, 15])
@pytest.mark.parametrize("log_p", [(50,), ()], ids=["single-P", "no-P"])
def test_base2_relinearization(log_p, w):
    """BGV mul_relin with a base-2 relinearization key stays exact, then
    again one level down (the key sliced to the lower level's rows)."""
    params = bgv.Parameters(bgv.ParametersLiteral(**lit(log_p, (45, 38, 38))), device="cpu")
    kg = rlwe.KeyGenerator(params)
    gen = torch.Generator().manual_seed(w + 1)
    sk = kg.gen_secret_key(gen)
    ev = bgv.Evaluator(params, rlwe.EvaluationKeySet(
        relinearization_key=kg.gen_relinearization_key(gen, sk, base2=w)))
    enc, dec = bgv.Encoder(params), rlwe.Decryptor(params, sk)
    rng = np.random.default_rng(6)
    m1, m2 = (rng.integers(0, params.t, params.n) for _ in range(2))
    encr = rlwe.Encryptor(params, sk)
    ct1, ct2 = (encr.encrypt(gen, enc.encode(m)) for m in (m1, m2))
    ct = ev.mul_relin(ct1, ct2)
    want = m1.astype(object) * m2 % params.t
    np.testing.assert_array_equal(enc.decode(dec.decrypt(ct)), want)
    down = ev.rescale(ct)
    sq = ev.mul_relin(down, down)
    assert sq.level == params.max_level - 1
    np.testing.assert_array_equal(enc.decode(dec.decrypt(sq)),
                                  want * want % params.t)


def test_base2_guards():
    """|P| > 1, a seed or RGSW row 1 are refused; with no P the RNS gadget
    and Galois keys raise as in the JAX package, the message naming base2."""
    two_p = bgv.Parameters(bgv.ParametersLiteral(**lit((50, 50))), device="cpu")
    kg = rlwe.KeyGenerator(two_p)
    gen = torch.Generator().manual_seed(0)
    sk = kg.gen_secret_key(gen)
    with pytest.raises(ValueError, match="P"):
        kg.gen_relinearization_key(gen, sk, base2=14)
    for kw in (dict(row=1), dict(seed=b"s")):
        with pytest.raises(ValueError, match="base-2"):
            kg.gadget_encrypt(gen, sk.value.q, sk, base2=14, **kw)
    no_p = bgv.Parameters(bgv.ParametersLiteral(**lit(())), device="cpu")
    kg = rlwe.KeyGenerator(no_p)
    sk = kg.gen_secret_key(gen)
    with pytest.raises(NotImplementedError, match="base2 > 0"):
        kg.gen_relinearization_key(gen, sk)
    with pytest.raises(NotImplementedError, match="P basis"):
        kg.gen_galois_keys(gen, [no_p.galois_element(1)], sk)


def jax_params(params):
    """The JAX package's parameters on the port's primes."""
    return jbgv.Parameters(jbgv.ParametersLiteral(
        log_n=params.log_n, q=tuple(params.q_moduli),
        p=tuple(params.p_moduli) or None, t=params.t))


@pytest.mark.parametrize("w", [13, 14])
def test_gadget_scalars_equal(w):
    params = bgv.Parameters(bgv.ParametersLiteral(**lit((50,), (45, 38, 30))), device="cpu")
    jp = jax_params(params)
    for level in (0, 2):
        got = rlwe.KeyGenerator(params)._gadget_scalars_base2(level, w)
        want = jrlwe.KeyGenerator(jp)._gadget_scalars_base2(level, w)
        np.testing.assert_array_equal(interop.to_numpy(got), np.asarray(want))


def product_case(params, w, batch, seed):
    """The port's base-2 key, a batch of random NTT polynomials c2 and both
    packages' gadget_product_base2 on them (the JAX one under jax.jit)."""
    kg = rlwe.KeyGenerator(params)
    gen = torch.Generator().manual_seed(seed)
    sk = kg.gen_secret_key(gen)
    gadget = kg.gen_relinearization_key(gen, sk, base2=w).gadget
    level = params.max_level
    rng = np.random.default_rng(seed)
    c2 = np.stack([rng.integers(0, q, (batch, params.n), dtype=np.uint64)
                   for q in params.q_moduli], axis=-2)
    got = rlwe.Evaluator(params).gadget_product_base2(
        interop.to_torch(c2, "cpu"), gadget, level)
    jev = jrlwe.Evaluator(jax_params(params))
    gq, gp = interop.qp_to_numpy(gadget.value)

    def run(c2, gq, gp):
        g = jrlwe.GadgetCiphertext(JQPPoly(gq, gp), base2=w)
        return jev.gadget_product_base2(c2, g, level)

    want = jax.jit(run).lower(c2, gq, gp).compile(FAST_COMPILE)(
        jnp.asarray(c2), jnp.asarray(gq), None if gp is None else jnp.asarray(gp))
    return gadget, c2, got, np.asarray(want)


@pytest.mark.parametrize("log_p, log_q", [((50,), (45, 38)), ((), (45, 38)),
                                          ((28,), (28, 28, 28))],
                         ids=["single-P", "no-P", "28-bit"])
def test_gadget_product_base2_bit_equal(log_p, log_q):
    """At 28 bits the port's Montgomery products take the 32-bit path."""
    params = bgv.Parameters(bgv.ParametersLiteral(**lit(log_p, log_q)), device="cpu")
    assert params.ring_q.small == (log_q[0] == 28)
    _, _, got, want = product_case(params, 14, 2, 3)
    np.testing.assert_array_equal(interop.to_numpy(got), want)


@pytest.mark.parametrize("bits", [60, 61])
def test_gadget_product_base2_wide_sums(bits):
    """The edge of the port's int64 row sums. Two primes just below 2^60 at
    w = 9 (7 digits each, 14 rows of lazy Montgomery terms below
    q·(1 + q/2^64), about q/2 on average): their plain sum passes 2^63 on
    many coefficients (shown on the terms themselves) yet stays below 2^64,
    so the JAX package's u64 sum is exact and the port, which folds every 3
    terms, must equal it bit for bit. Two primes just above 2^60 at w = 4
    (16 digits each, 32 rows): the plain sum passes 2^64, where the JAX
    package's u64 sum wraps; the port must still give the exact residue of
    the sum."""
    gen = NTTFriendlyPrimesGenerator(60, 128)
    draw = gen.next_downstream_prime if bits == 60 else gen.next_upstream_prime
    q = (draw(), draw())
    params = bgv.Parameters(bgv.ParametersLiteral(log_n=6, q=q, t=65537), device="cpu")
    assert all((1 << 59) < x < (1 << 60) if bits == 60 else (1 << 60) < x < (1 << 61)
               for x in q)
    w, batch = (9, 3) if bits == 60 else (4, 3)
    gadget, c2, got, want = product_case(params, w, batch, 11)
    rq = params.ring_q
    rows = gadget.value.q.shape[0]
    dig = rows // 2
    assert rows == (14 if bits == 60 else 32)
    # the lazy terms the product sums, and their exact sum per coefficient
    cx = rq.intt(interop.to_torch(c2, "cpu"))
    digits = (cx[..., :, None, :] >> (torch.arange(dig) * w)[:, None]) & ((1 << w) - 1)
    d = rq.ntt(digits.reshape(batch, rows, 1, params.n).expand(batch, rows, 2, params.n))
    t = modops.mred_lazy(d[..., :, None, :, :], gadget.value.q, rq.q, rq.qinv, rq.small)
    total = interop.to_numpy(t).astype(object).sum(axis=1)     # [batch, 2, 2, N]
    exact = total % np.array(q, dtype=object)[:, None]
    np.testing.assert_array_equal(interop.to_numpy(got).astype(object), exact)
    if bits == 60:
        assert (total >= (1 << 63)).sum() > 10 and (total < (1 << 64)).all()
        np.testing.assert_array_equal(interop.to_numpy(got), want)
    else:
        assert (total >= (1 << 64)).sum() > 10
