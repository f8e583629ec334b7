"""Port parity for the CKKS domain switcher (standard ↔ conjugate-invariant).

On ``tests/test_bridge.py``'s chain (one 50-bit and one 40-bit Q prime, one
55-bit P prime, all ≡ 1 mod 1024), standard ring logN 9 and CI ring logN 8:
the port makes the two secrets, the ring-swap keys and a batch of two
ciphertexts; ``unfold_secret`` and both ``DomainSwitcher`` directions must
give the JAX package's residues on them (tolerance 0; the JAX side under
one ``jax.jit``) and equal ``Fraction`` scales. The port's results decode
to Re(m) at that file's floors.
"""

from fractions import Fraction

import numpy as np
import jax
import pytest
import torch

from lattigo_tpu import rlwe as jrlwe
from lattigo_tpu.ring.ringqp import QPPoly as JQPPoly
from lattigo_tpu.schemes import ckks as jckks
from lattigo_tpu.schemes.ckks import bridge as jbridge
from lattigo_tpu.utils.primes import NTTFriendlyPrimesGenerator
from lattigo_tpu_torch import interop, rlwe as trlwe
from lattigo_tpu_torch.ring.ring import CONJUGATE_INVARIANT
from lattigo_tpu_torch.schemes import ckks as tckks
from lattigo_tpu_torch.schemes.ckks import bridge as tbridge
from test_torch_ci_ring import FAST_COMPILE, jit_gadget_products

N_CI = 256
BATCH = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's ops here act on small tensors, where torch's intra-op
    threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _literals(mod):
    q = tuple(NTTFriendlyPrimesGenerator(b, 4 * N_CI).next_alternating_prime()
              for b in (50, 40))
    p = (NTTFriendlyPrimesGenerator(55, 4 * N_CI).next_alternating_prime(),)
    return (mod.ParametersLiteral(log_n=9, q=q, p=p, log_default_scale=40),
            mod.ParametersLiteral(log_n=8, q=q, p=p, log_default_scale=40,
                                  ring_type=CONJUGATE_INVARIANT))


@pytest.fixture(scope="module")
def bridge():
    std_lit, ci_lit = _literals(tckks)
    p_std = tckks.Parameters(std_lit, device="cpu")
    p_ci = tckks.Parameters(ci_lit, device="cpu")
    gen = torch.Generator().manual_seed(0)
    sk_std = trlwe.KeyGenerator(p_std).gen_secret_key(gen)
    sk_ci = trlwe.KeyGenerator(p_ci).gen_secret_key(gen)
    s2c, c2s = tbridge.gen_ring_swap_keys(gen, p_std, sk_std, sk_ci)
    sw = tbridge.DomainSwitcher(p_std, p_ci, s2c, c2s)
    rng = np.random.default_rng(1)
    v = (rng.uniform(-1, 1, (BATCH, p_std.max_slots))
         + 1j * rng.uniform(-1, 1, (BATCH, p_std.max_slots)))
    ct = trlwe.Encryptor(p_std, sk_std).encrypt(gen, tckks.Encoder(p_std).encode(v),
                                                batch=(BATCH,))
    ct_ci = sw.complex_to_real(ct)
    back = sw.real_to_complex(ct_ci)

    j_std, j_ci = (jckks.Parameters(lit) for lit in _literals(jckks))
    assert (j_std.q_moduli, j_std.p_moduli) == (p_std.q_moduli, p_std.p_moduli)
    scale = p_std.default_scale_fraction
    meta = {}

    def run(sk_ci_qp, s2c_qp, c2s_qp, value):
        jsw = jbridge.DomainSwitcher(
            j_std, j_ci, jrlwe.EvaluationKey(jrlwe.GadgetCiphertext(JQPPoly(*s2c_qp))),
            jrlwe.EvaluationKey(jrlwe.GadgetCiphertext(JQPPoly(*c2s_qp))))
        jit_gadget_products(jsw.ev)
        unfolded = jbridge.unfold_secret(j_std, jrlwe.SecretKey(JQPPoly(*sk_ci_qp)))
        down = jsw.complex_to_real(jrlwe.Ciphertext(value=value, scale=scale))
        up = jsw.real_to_complex(down)
        meta.update(down=Fraction(down.scale), up=Fraction(up.scale))
        return dict(unfolded=unfolded.value, down=down.value, up=up.value)

    ref = jax.tree_util.tree_map(np.asarray, jax.jit(run, compiler_options=FAST_COMPILE)(
        interop.qp_to_numpy(sk_ci.value), interop.qp_to_numpy(s2c.gadget.value),
        interop.qp_to_numpy(c2s.gadget.value), interop.to_numpy(ct.value)))
    return dict(p_std=p_std, p_ci=p_ci, sk_std=sk_std, sk_ci=sk_ci, v=v, ct=ct,
                down=ct_ci, up=back, ref=ref, meta=meta)


def test_unfold_secret_equal(bridge):
    got = tbridge.unfold_secret(bridge["p_std"], bridge["sk_ci"]).value
    want = bridge["ref"]["unfolded"]
    np.testing.assert_array_equal(interop.to_numpy(got.q), want[0])
    np.testing.assert_array_equal(interop.to_numpy(got.p), want[1])


@pytest.mark.parametrize("direction", ["down", "up"])
def test_switch_bit_equal(bridge, direction):
    got = bridge[direction]
    assert Fraction(got.scale) == bridge["meta"][direction]
    np.testing.assert_array_equal(interop.to_numpy(got.value), bridge["ref"][direction])


def test_switch_decodes(bridge):
    p_std, p_ci, v = bridge["p_std"], bridge["p_ci"], bridge["v"]
    assert bridge["down"].n == p_ci.n and bridge["up"].n == p_std.n
    assert Fraction(bridge["down"].scale) == 2 * bridge["ct"].scale
    got_re = tckks.CIEncoder(p_ci).decode(
        trlwe.Decryptor(p_ci, bridge["sk_ci"]).decrypt(bridge["down"]))
    assert got_re.shape == v.shape
    assert np.abs(got_re - v.real).max() < 1e-7
    got = tckks.Encoder(p_std).decode(
        trlwe.Decryptor(p_std, bridge["sk_std"]).decrypt(bridge["up"]))
    assert np.abs(got - v.real).max() < 1e-6


def test_switcher_rejects_other_chains(bridge):
    p_std, p_ci = bridge["p_std"], bridge["p_ci"]
    with pytest.raises(ValueError, match="twice"):
        tbridge.DomainSwitcher(p_std, p_std, None, None)


# -- the floors of chip_smoke.py phase 9a ---------------------------------------------

def reference_phase9_bits(log_n: int = 14) -> dict:
    """The JAX package's precision (min, avg bits) on chip_smoke.py phase
    9a's CKKS operations, with its parameters, flow and inputs (its own
    keys): the CI request rotate(rescale(mul_relin(a, b)), 1) on the CI
    twin of ``ckks_tpu_params(log_n, 438)``, then complex_to_real of a
    batch at logN and real_to_complex back. Everything but the host
    decode runs under one ``jax.jit``."""
    import sys
    import time
    from pathlib import Path

    from lattigo_tpu import presets as jpresets
    from lattigo_tpu.schemes.ckks.encoder import CIEncoder as JCIEncoder
    from lattigo_tpu.schemes.ckks.precision import get_precision_stats

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    t0 = time.time()
    lit = jpresets.ckks_tpu_params(log_n, cs.LOG_QP)
    p_std = jckks.Parameters(lit)
    p_ci = jckks.Parameters(jckks.ParametersLiteral(
        log_n=log_n - 1, q=tuple(p_std.q_moduli), p=tuple(p_std.p_moduli),
        log_default_scale=lit.log_default_scale, ring_type=CONJUGATE_INVARIANT))
    x = cs.ring_inputs(p_ci.n, p_std.max_slots)
    enc_std, enc_ci = jckks.Encoder(p_std), JCIEncoder(p_ci)
    rot = p_ci.galois_element(1)

    def run(key):
        k = jax.random.split(key, 8)
        kg_ci, kg = jrlwe.KeyGenerator(p_ci), jrlwe.KeyGenerator(p_std)
        sk_ci, sk = kg_ci.gen_secret_key(k[0]), kg.gen_secret_key(k[1])
        ev_ci = jit_gadget_products(jckks.Evaluator(p_ci, jrlwe.EvaluationKeySet(
            kg_ci.gen_relinearization_key(k[2], sk_ci),
            {rot: kg_ci.gen_galois_key(k[3], rot, sk_ci)})))
        encr_ci = jrlwe.Encryptor(p_ci, sk_ci)
        ca = encr_ci.encrypt(k[4], enc_ci.encode(x["a"]), batch=(cs.BATCH,))
        cb = encr_ci.encrypt(k[5], enc_ci.encode(x["b"]), batch=(cs.BATCH,))
        req = ev_ci.rotate(ev_ci.rescale(ev_ci.mul_relin(ca, cb)), 1)
        sw = jbridge.DomainSwitcher(p_std, p_ci, *jbridge.gen_ring_swap_keys(
            k[6], p_std, sk, sk_ci))
        jit_gadget_products(sw.ev)
        cz = jrlwe.Encryptor(p_std, sk).encrypt(k[7], enc_std.encode(x["z"]),
                                                batch=(cs.BATCH,))
        down = sw.complex_to_real(cz)
        up = sw.real_to_complex(down)
        out = {}
        for name, ct, p, s in (("ci request", req, p_ci, sk_ci),
                               ("complex_to_real", down, p_ci, sk_ci),
                               ("real_to_complex", up, p_std, sk)):
            pt = jrlwe.Decryptor(p, s).decrypt(ct)
            out[name] = (p.ring_q.intt(pt.value, pt.level), Fraction(ct.scale))
        return {k: v for k, (v, _) in out.items()}, {k: s for k, (_, s) in out.items()}

    scales = {}

    def values(key):
        v, s = run(key)
        scales.update(s)
        return v

    coeffs = jax.jit(values, compiler_options=FAST_COMPILE)(jax.random.PRNGKey(cs.SEED))
    print(f"JAX program {time.time() - t0:.0f} s", flush=True)
    want = {"ci request": (np.roll(x["a"] * x["b"], -1, axis=-1), enc_ci, p_ci),
            "complex_to_real": (x["z"].real, enc_ci, p_ci),
            "real_to_complex": (x["z"].real + 0j, enc_std, p_std)}
    bits = {}
    for name, (w, enc, p) in want.items():
        c = np.asarray(coeffs[name])
        got = np.stack([enc.decode(jrlwe.Plaintext(value=c[i], is_ntt=False,
                                                   scale=scales[name]))
                        for i in range(c.shape[0])])
        st = get_precision_stats(w, got)
        bits[name] = (st.min_precision, st.avg_precision)
        print(name, bits[name], flush=True)
    return bits


if __name__ == "__main__":
    import sys
    print(reference_phase9_bits(int(sys.argv[1]) if len(sys.argv) > 1 else 14))
