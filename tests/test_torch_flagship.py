"""Port parity for the flagship 40-bit chain of ``__graft_entry__.py``.

Its ``entry()`` set-up: logN 12, Q = 3 x 40-bit and P = 45-bit primes, T
the first 16-bit prime of ``NTTFriendlyPrimesGenerator(16, 2N)``, a batch
of 4, ``rescale(mul_relin(a, b))``. Every prime is ≥ 2^30, so the port's
rings run the plain radix-2 engine. The JAX package makes the keys and
ciphertexts and runs the step under one ``jax.jit`` each; the port, on the
carried relinearization key and ciphertexts, must give the same residues
(tolerance 0), level and T-scale, and decrypt to numpy's a·b mod T.
"""

import numpy as np
import jax
import pytest
import torch

from lattigo_tpu import rlwe as jrlwe
from lattigo_tpu.ring.ringqp import QPPoly as JQPPoly
from lattigo_tpu.schemes import bgv as jbgv
from lattigo_tpu.utils.primes import NTTFriendlyPrimesGenerator as JGen
from lattigo_tpu_torch import interop, rlwe as trlwe
from lattigo_tpu_torch.schemes import bgv as tbgv
from lattigo_tpu_torch.utils.primes import NTTFriendlyPrimesGenerator as TGen

LOG_N, BATCH = 12, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _literal(module, gen):
    t = gen(16, 2 << LOG_N).next_alternating_prime()
    return module.ParametersLiteral(log_n=LOG_N, log_q=(40,) * 3, log_p=(45,), t=t)


@pytest.fixture(scope="module")
def ref():
    pj = jbgv.Parameters(_literal(jbgv, JGen))
    pt = tbgv.Parameters(_literal(tbgv, TGen), device="cpu")
    rng = np.random.default_rng(57)
    va, vb = (rng.integers(0, pt.t, (BATCH, pt.n)) for _ in range(2))
    enc = tbgv.Encoder(pt)
    pa, pb = (interop.to_numpy(enc.encode(v).value) for v in (va, vb))
    kg = jrlwe.KeyGenerator(pj)
    scales = {}

    def setup(key, pa, pb):
        k_sk, k_rlk, k1, k2 = jax.random.split(key, 4)
        sk = kg.gen_secret_key(k_sk)
        rlk = kg.gen_relinearization_key(k_rlk, sk)
        e = jrlwe.Encryptor(pj, sk)
        ca = e.encrypt(k1, jrlwe.Plaintext(value=pa), batch=(BATCH,))
        cb = e.encrypt(k2, jrlwe.Plaintext(value=pb), batch=(BATCH,))
        return dict(sk_q=sk.value.q, sk_p=sk.value.p, rlk_q=rlk.gadget.value.q,
                    rlk_p=rlk.gadget.value.p, ca=ca.value, cb=cb.value)

    def step(rlk_q, rlk_p, va_, vb_):
        ev = jbgv.Evaluator(pj, jrlwe.EvaluationKeySet(jrlwe.RelinearizationKey(
            jrlwe.GadgetCiphertext(JQPPoly(rlk_q, rlk_p)))))
        out = ev.rescale(ev.mul_relin(jrlwe.Ciphertext(value=va_, scale=1),
                                      jrlwe.Ciphertext(value=vb_, scale=1)))
        scales["out"] = (out.level, out.scale)
        return out.value

    a = {k: np.asarray(v) for k, v in
         jax.jit(setup)(jax.random.PRNGKey(0), pa, pb).items()}
    a["out"] = np.asarray(jax.jit(step)(a["rlk_q"], a["rlk_p"], a["ca"], a["cb"]))
    return dict(pj=pj, pt=pt, va=va, vb=vb, arrays=a, meta=scales["out"])


def test_flagship_parameters_equal(ref):
    pj, pt = ref["pj"], ref["pt"]
    assert (pt.q_moduli, pt.p_moduli, pt.t) == (pj.q_moduli, pj.p_moduli, pj.t)
    assert all(1 << 39 < q < 1 << 41 for q in pt.q_moduli) and pt.t < 1 << 17
    assert pt.ring_q.ntt_engine == pt.ring_p.ntt_engine == "radix2-plain"


def test_flagship_step_bit_equal(ref):
    pt, a = ref["pt"], ref["arrays"]
    rlk = interop.relinearization_key_from_numpy(a["rlk_q"], a["rlk_p"], "cpu")
    ev = tbgv.Evaluator(pt, trlwe.EvaluationKeySet(rlk))
    out = ev.rescale(ev.mul_relin(interop.ciphertext_from_numpy(a["ca"], "cpu"),
                                  interop.ciphertext_from_numpy(a["cb"], "cpu")))
    assert (out.level, out.scale) == ref["meta"]
    np.testing.assert_array_equal(interop.to_numpy(out.value), a["out"])
    sk = interop.secret_key_from_numpy(a["sk_q"], a["sk_p"], "cpu")
    got = tbgv.Encoder(pt).decode(trlwe.Decryptor(pt, sk).decrypt(out))
    want = ref["va"].astype(object) * ref["vb"] % pt.t
    np.testing.assert_array_equal(got, want.astype(np.int64))
