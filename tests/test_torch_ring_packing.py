"""Port parity for ring packing: Expand / Unpack / Pack within one ring
degree, Split / Merge / Extract / Repack across two.

At ``tests/test_ring_packing.py``'s parameters (logN 7 with a 45- and a
38-bit Q prime and a 50-bit P prime; the cross-degree pair logN 7 / 8 on
one chain): the port makes every key (secrets, the Galois keys of the
expand and pack trees, the ring-switching keys) and the input ciphertexts;
the JAX package runs each operation on them under one ``jax.jit``, and every
output must have its residues (tolerance 0) and scale. The Galois-element
lists must be the JAX package's. Then the port's outputs decrypt to the
exact coefficients that file checks.

The JAX package computes its X^k factors with its radix-2 NTT eagerly, op
by op, inside the trace (one XLA compile per op and shape, ~7 s a ring);
here that NTT runs as one ``jax.jit`` per shape instead
(``jitted_constant_ntts``).
"""

import numpy as np
import jax
import pytest
import torch

from lattigo_tpu import rlwe as jrlwe
from lattigo_tpu.ring.ringqp import QPPoly as JQPPoly
from lattigo_tpu.rlwe import ring_packing as jrp
from lattigo_tpu.schemes import bgv as jbgv
from lattigo_tpu.utils.primes import NTTFriendlyPrimesGenerator
from lattigo_tpu_torch import interop, rlwe as trlwe
from lattigo_tpu_torch.rlwe import ring_packing as trp
from lattigo_tpu_torch.schemes import bgv as tbgv
from test_torch_ci_ring import FAST_COMPILE, jit_gadget_products, jitted_constant_ntts

DELTA = 1 << 25
LOG_GAP = 5                      # expand keeps every 32nd coefficient
LOG_PACK = 3                     # unpack / pack of 8 ciphertexts
EXTRACT = [0, 1, 64, 129, 193]   # two residues, gaps of 32 and more


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's ops here act on small tensors, where torch's intra-op
    threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _encrypt_coeffs(params, sk, gen, m):
    rq = params.ring_q
    poly = rq.ntt(rq.from_int_coeffs([int(x) * DELTA for x in m]))
    return trlwe.Encryptor(params, sk).encrypt(gen, trlwe.Plaintext(value=poly, is_ntt=True))


def _decrypt_coeffs(params, sk, ct):
    pt = trlwe.Decryptor(params, sk).decrypt(ct)
    v = params.ring_q.intt(pt.value, pt.level)
    return [int(round(c / DELTA)) for c in params.ring_q.to_int_coeffs(v, pt.level)]


def _pack_gal_els(rp):
    return sorted(set(rp.galois_elements_for_expand()) | set(rp.galois_elements_for_pack()))


def _jax_keys(gks):
    return {g: jrlwe.GaloisKey(jrlwe.GadgetCiphertext(JQPPoly(*k)), g) for g, k in gks.items()}


def _gks_np(gks):
    return {g: interop.qp_to_numpy(k.gadget.value) for g, k in gks.items()}


def _values_and_scales(out: dict, scales: dict) -> dict:
    """The JAX outputs' residues (returned from the jit) and their scales
    (host metadata, recorded while it traces)."""
    scales.update({k: c.scale for k, c in out.items()})
    return {k: c.value for k, c in out.items()}


def _assert_bit_equal(port: dict, ref: dict):
    assert sorted(port) == sorted(ref)
    for k, ct in port.items():
        value, scale = ref[k]
        assert ct.scale == scale, k
        np.testing.assert_array_equal(interop.to_numpy(ct.value), value, err_msg=str(k))


# -- one ring degree: expand, unpack, pack ------------------------------------------

@pytest.fixture(scope="module")
def one():
    lit = dict(log_n=7, log_q=(45, 38), log_p=(50,), t=65537)
    pt = tbgv.Parameters(tbgv.ParametersLiteral(**lit), device="cpu")
    pj = jbgv.Parameters(jbgv.ParametersLiteral(**lit))
    assert (pt.q_moduli, pt.p_moduli) == (pj.q_moduli, pj.p_moduli)
    gen = torch.Generator().manual_seed(0)
    kg = trlwe.KeyGenerator(pt)
    sk = kg.gen_secret_key(gen)
    rp0 = trp.RingPackingEvaluator(trlwe.Evaluator(pt))
    jrp0 = jrp.RingPackingEvaluator(jrlwe.Evaluator(pj))
    assert _pack_gal_els(rp0) == _pack_gal_els(jrp0)
    gks = kg.gen_galois_keys(gen, _pack_gal_els(rp0), sk)
    rp = trp.RingPackingEvaluator(trlwe.Evaluator(pt, trlwe.EvaluationKeySet(galois_keys=gks)))
    rng = np.random.default_rng(1)
    m = rng.integers(-7, 8, pt.n)
    vals = rng.integers(-7, 8, 8)
    gap = pt.n // 8
    ct = _encrypt_coeffs(pt, sk, gen, m)
    consts = {i * gap: _encrypt_coeffs(pt, sk, gen, [int(vals[i])] + [0] * (pt.n - 1))
              for i in range(8)}

    def ops(rp, ct, consts):
        out = {("expand", k): c for k, c in rp.expand(ct, LOG_GAP).items()}
        parts = rp.unpack(ct, LOG_PACK)
        out.update({("unpack", j): c for j, c in enumerate(parts)})
        out[("repack", 0)] = rp.pack(dict(enumerate(parts)), input_log_gap=LOG_PACK)
        out[("pack", 0)] = rp.pack(consts, input_log_gap=pt.log_n)
        return out

    def run(gks_np, value, const_values):
        jev = jit_gadget_products(jrlwe.Evaluator(pj, jrlwe.EvaluationKeySet(
            galois_keys=_jax_keys(gks_np))))
        out = ops(jrp.RingPackingEvaluator(jev), jrlwe.Ciphertext(value=value),
                  {k: jrlwe.Ciphertext(value=v) for k, v in const_values.items()})
        return _values_and_scales(out, scales)

    scales = {}
    with jitted_constant_ntts((jrp.RingPackingEvaluator, "_x_pow_mont")):
        values = jax.jit(run, compiler_options=FAST_COMPILE)(
            _gks_np(gks), interop.to_numpy(ct.value),
            {k: interop.to_numpy(c.value) for k, c in consts.items()})
    ref = {k: (np.asarray(v), scales[k]) for k, v in values.items()}
    return dict(pt=pt, pj=pj, sk=sk, m=m, vals=vals, gap=gap, rp=rp,
                port=ops(rp, ct, consts), ref=ref)


def test_galois_elements_equal(one):
    rp = one["rp"]
    jrp0 = jrp.RingPackingEvaluator(jrlwe.Evaluator(one["pj"]))
    for log_n in (None, 5, 7):
        assert rp.galois_elements_for_expand(log_n) == jrp0.galois_elements_for_expand(log_n)
    for start in range(8):
        assert rp.galois_elements_for_pack(start) == jrp0.galois_elements_for_pack(start)
    for log_pack in range(1, 8):
        assert (rp.galois_elements_for_unpack(log_pack)
                == jrp0.galois_elements_for_unpack(log_pack))


def test_one_degree_bit_equal(one):
    _assert_bit_equal(one["port"], one["ref"])


def test_expand(one):
    """cts[i] holds coefficient i of the input in its constant coefficient."""
    pt, sk, m = one["pt"], one["sk"], one["m"]
    cts = {k: c for (op, k), c in one["port"].items() if op == "expand"}
    assert sorted(cts) == list(range(0, pt.n, 1 << LOG_GAP))
    for i, c in cts.items():
        assert _decrypt_coeffs(pt, sk, c)[0] == int(m[i]), f"slot {i}"


def test_unpack_then_pack(one):
    """unpack keeps each coefficient class mod 2^LOG_PACK, shifted down;
    pack of its output gives back the input."""
    pt, sk, m = one["pt"], one["sk"], one["m"]
    stride = 1 << LOG_PACK
    for j in range(stride):
        got = _decrypt_coeffs(pt, sk, one["port"][("unpack", j)])
        want = [int(m[i + j]) if i % stride == 0 and i + j < pt.n else 0
                for i in range(pt.n)]
        assert got == want, f"class {j}"
    assert _decrypt_coeffs(pt, sk, one["port"][("repack", 0)]) == [int(x) for x in m]


def test_pack(one):
    """pack interleaves the constant coefficients of 8 ciphertexts."""
    pt, sk = one["pt"], one["sk"]
    coeffs = _decrypt_coeffs(pt, sk, one["port"][("pack", 0)])
    for i, v in enumerate(one["vals"]):
        assert coeffs[i * one["gap"]] == int(v), f"coeff {i * one['gap']}"


# -- two ring degrees: split, merge, extract, repack ---------------------------------

def _cross_params(mod):
    nth = 2 * 256
    q = (NTTFriendlyPrimesGenerator(45, nth).next_alternating_prime(),
         NTTFriendlyPrimesGenerator(38, nth).next_alternating_prime())
    p = (NTTFriendlyPrimesGenerator(50, nth).next_alternating_prime(),)
    kw = {} if mod is jrlwe else dict(device="cpu")
    return {l: mod.Parameters(mod.ParametersLiteral(log_n=l, q=q, p=p), **kw)
            for l in (7, 8)}


@pytest.fixture(scope="module")
def two():
    params = _cross_params(trlwe)
    gen = torch.Generator().manual_seed(10)
    sks = {l: trlwe.KeyGenerator(params[l]).gen_secret_key(gen) for l in (7, 8)}
    switching = trp.gen_ring_switching_keys(gen, params, sks)
    gks = {}
    for l in (7, 8):
        els = _pack_gal_els(trp.RingPackingEvaluator(trlwe.Evaluator(params[l])))
        gks[l] = trlwe.KeyGenerator(params[l]).gen_galois_keys(gen, els, sks[l])
    evs = {l: trlwe.Evaluator(params[l], trlwe.EvaluationKeySet(galois_keys=gks[l]))
           for l in (7, 8)}
    rp = trp.RingPackingEvaluator(evs[8], switching=switching, evaluators=evs)
    rng = np.random.default_rng(7)
    m = rng.integers(-7, 8, params[8].n)
    ct = _encrypt_coeffs(params[8], sks[8], gen, m)

    def ops(rp, ct):
        even, odd = rp.split(ct)
        out = {("even", 0): even, ("odd", 0): odd, ("merge", 0): rp.merge(even, odd)}
        cts = rp.extract(ct, EXTRACT)
        out.update({("extract", k): c for k, c in cts.items()})
        out[("repack", 0)] = rp.repack(cts)
        return out

    jparams = _cross_params(jrlwe)
    for l in (7, 8):
        assert jparams[l].q_moduli == params[l].q_moduli

    def evk(rows):
        return jrlwe.EvaluationKey(jrlwe.GadgetCiphertext(JQPPoly(*rows)))

    def run(down, up, gks_np, value):
        jevs = {l: jit_gadget_products(jrlwe.Evaluator(jparams[l], jrlwe.EvaluationKeySet(
            galois_keys=_jax_keys(gks_np[l])))) for l in (7, 8)}
        sw = jrp.RingSwitchingKeys(jparams, {8: evk(down)}, {8: evk(up)})
        out = ops(jrp.RingPackingEvaluator(jevs[8], switching=sw, evaluators=jevs),
                  jrlwe.Ciphertext(value=value))
        return _values_and_scales(out, scales)

    scales = {}
    with jitted_constant_ntts((jrp.RingPackingEvaluator, "_x_pow_mont")):
        values = jax.jit(run, compiler_options=FAST_COMPILE)(
            interop.qp_to_numpy(switching.down[8].gadget.value),
            interop.qp_to_numpy(switching.up[8].gadget.value),
            {l: _gks_np(gks[l]) for l in (7, 8)}, interop.to_numpy(ct.value))
    ref = {k: (np.asarray(v), scales[k]) for k, v in values.items()}
    carried = interop.ring_switching_keys_from_numpy(
        params, {8: interop.qp_to_numpy(switching.down[8].gadget.value)},
        {8: interop.qp_to_numpy(switching.up[8].gadget.value)}, "cpu")
    return dict(params=params, sks=sks, m=m, port=ops(rp, ct), ref=ref,
                switching=switching, carried=carried)


def test_two_degrees_bit_equal(two):
    _assert_bit_equal(two["port"], two["ref"])


def test_ring_switching_keys_carried(two):
    sw, carried = two["switching"], two["carried"]
    assert (carried.min_log_n, carried.max_log_n) == (7, 8)
    for keys, got in ((sw.down, carried.down), (sw.up, carried.up)):
        assert sorted(got) == sorted(keys) == [8]
        assert torch.equal(got[8].gadget.value.q, keys[8].gadget.value.q)
        assert torch.equal(got[8].gadget.value.p, keys[8].gadget.value.p)


def test_split_merge(two):
    """ctN[X] = even[Y] + X·odd[Y]: split halves the degree, merge inverts."""
    params, sks, m, port = two["params"], two["sks"], two["m"], two["port"]
    assert _decrypt_coeffs(params[7], sks[7], port[("even", 0)]) == list(m[0::2])
    assert _decrypt_coeffs(params[7], sks[7], port[("odd", 0)]) == list(m[1::2])
    assert _decrypt_coeffs(params[8], sks[8], port[("merge", 0)]) == list(m)


def test_extract_repack(two):
    """extract pulls coefficients into constant coefficients of half-degree
    ciphertexts; repack inverts it and zeroes every other coefficient."""
    params, sks, m, port = two["params"], two["sks"], two["m"], two["port"]
    for i in EXTRACT:
        c = port[("extract", i)]
        assert c.n == params[7].n
        assert _decrypt_coeffs(params[7], sks[7], c)[0] == int(m[i]), f"idx {i}"
    want = [int(m[i]) if i in EXTRACT else 0 for i in range(params[8].n)]
    assert _decrypt_coeffs(params[8], sks[8], port[("repack", 0)]) == want
