"""Port parity for rotations: Galois keys (level-scoped too), CKKS rotate,
conjugate and hoisted rotations, inner sums, replicate, trace, partial
traces, and BGV column / row rotations.

At logN=10 with 40–55-bit primes (the radix-2 engine and the wide
Montgomery path): the JAX package makes the keys and ciphertexts under one
``jax.jit``, the port runs every op on them carried over, and the residues
must be equal (tolerance 0) with equal scales. Then the port's own Galois
keys, level-scoped and made in chunks, decrypt its rotations at the floors
of ``tests/test_ckks.py`` and ``tests/test_innersum.py``.
"""

from fractions import Fraction

import numpy as np
import jax
import pytest
import torch

from lattigo_tpu import rlwe as jrlwe
from lattigo_tpu.schemes import bgv as jbgv, ckks as jckks
from lattigo_tpu_torch import interop, rlwe as trlwe
from lattigo_tpu_torch.schemes import bgv as tbgv, ckks as tckks

LOG_N = 10
CKKS_LIT = dict(log_n=LOG_N, log_q=(50, 40, 40), log_p=(55,), log_default_scale=40)
BGV_LIT = dict(log_n=LOG_N, log_q=(45, 35, 35), log_p=(50,), t=65537)
BATCH = 2
SCOPED_LEVEL = 1      # the level-scoped key's level (the chain's top is 2)
SCOPED_K = 5          # its rotation

CKKS_OPS = {
    "rotate": lambda ev, ct: {0: ev.rotate(ct, 1)},
    "conjugate": lambda ev, ct: {0: ev.conjugate(ct)},
    "rotate_hoisted": lambda ev, ct: ev.rotate_hoisted(ct, [0, 1, 7]),
    "inner_sum": lambda ev, ct: {0: ev.inner_sum(ct, 2, 3)},
    "replicate": lambda ev, ct: {0: ev.replicate(ct, 2, 3)},
    "trace": lambda ev, ct: {0: ev.trace(ct, LOG_N - 2)},
    "partial_traces_sum": lambda ev, ct: {0: ev.partial_traces_sum(ct, 3, 3)},
    # a level-scoped key at its own level, beside a full-chain key
    "level_scoped_hoisted": lambda ev, ct: ev.rotate_hoisted(
        ct.at_level(SCOPED_LEVEL), [1, SCOPED_K]),
}

BGV_OPS = {
    "rotate_columns": lambda ev, ct: {0: ev.rotate_columns(ct, 1)},
    "rotate_rows": lambda ev, ct: {0: ev.rotate_rows(ct)},
    "rotate_hoisted": lambda ev, ct: ev.rotate_hoisted(ct, [1, 2]),
    "rotate_columns_hoisted": lambda ev, ct: ev.rotate_columns_hoisted(ct, [2]),
    "rotate_and_add": lambda ev, ct: {0: ev.rotate_and_add(ct, 1, 3)},
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here, and
    they crowd the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ckks_gal_els(ev, p):
    els = {p.galois_element(k) for k in (1, -3, 7)}
    els.add(p.galois_element_order_two)
    for batch, n in ((2, 3), (-2, 3), (2, 5), (-2, 5)):
        els |= set(ev.galois_elements_for_inner_sum(batch, n))
    for start in (LOG_N - 2, LOG_N - 3):
        els |= set(ev.galois_elements_for_trace(start))
    for n in (3, 4):
        els |= set(ev.galois_elements_for_partial_traces_sum(3, n))
    els.discard(p.galois_element(SCOPED_K))
    return sorted(els) + [p.galois_element(SCOPED_K)]


def _bgv_gal_els(p):
    return sorted({p.galois_element(k) for k in (1, 2)}
                  | {p.galois_element_order_two})


def _run_jax(pj, ops, gal_els, levels, values, key):
    """Keys, a batch of ciphertexts and every op under one jax.jit; returns
    numpy arrays, the ops' scales and the keys' rows."""
    kg = jrlwe.KeyGenerator(pj)
    scales = {}

    def setup(key, pt_value):
        k1, k2, k3 = jax.random.split(key, 3)
        sk = kg.gen_secret_key(k1)
        gks = kg.gen_galois_keys(k2, gal_els, sk, levels=levels)
        pt = jrlwe.Plaintext(value=pt_value, scale=values.scale)
        ct = jrlwe.Encryptor(pj, sk).encrypt(k3, pt, batch=(BATCH,))
        ev = type(values.evaluator)(pj, jrlwe.EvaluationKeySet(galois_keys=gks))
        out = {}
        for name, op in ops.items():
            for k, r in op(ev, ct).items():
                out[f"{name}/{k}"] = r.value
                scales[f"{name}/{k}"] = r.scale
        keys = {f"gk/{g}/{part}": getattr(gk.gadget.value, part)
                for g, gk in gks.items() for part in ("q", "p")}
        return dict(out, **keys, sk_q=sk.value.q, sk_p=sk.value.p, ct=ct.value)

    arrays = jax.jit(setup)(key, values.pt)
    return {k: np.asarray(v) for k, v in arrays.items()}, scales


class _Values:
    def __init__(self, pt, evaluator):
        self.pt, self.scale, self.evaluator = pt.value, pt.scale, evaluator


@pytest.fixture(scope="module")
def ref():
    pj = jckks.Parameters(jckks.ParametersLiteral(**CKKS_LIT))
    ev0 = jckks.Evaluator(pj)
    gal_els = _ckks_gal_els(ev0, pj)
    levels = {pj.galois_element(SCOPED_K): SCOPED_LEVEL}
    rng = np.random.default_rng(31)
    v = rng.uniform(-1, 1, (BATCH, pj.max_slots)) + 1j * rng.uniform(-1, 1, (BATCH, pj.max_slots))
    pt = jax.jit(lambda: jckks.Encoder(pj).encode(v).value)()
    vals = _Values(jrlwe.Plaintext(value=pt, scale=pj.default_scale_fraction), ev0)
    arrays, scales = _run_jax(pj, CKKS_OPS, gal_els, levels, vals,
                              jax.random.PRNGKey(5))
    return dict(pj=pj, pt=tckks.Parameters(tckks.ParametersLiteral(**CKKS_LIT),
                                           device="cpu"),
                gal_els=gal_els, arrays=arrays, scales=scales)


@pytest.fixture(scope="module")
def ref_bgv():
    pj = jbgv.Parameters(jbgv.ParametersLiteral(**BGV_LIT))
    rng = np.random.default_rng(32)
    m = rng.integers(0, pj.t, (BATCH, pj.n))
    pt = jax.jit(lambda: jbgv.Encoder(pj).encode(m).value)()
    vals = _Values(jrlwe.Plaintext(value=pt, scale=1), jbgv.Evaluator(pj))
    gal_els = _bgv_gal_els(pj)
    arrays, scales = _run_jax(pj, BGV_OPS, gal_els, None, vals,
                              jax.random.PRNGKey(6))
    return dict(pt=tbgv.Parameters(tbgv.ParametersLiteral(**BGV_LIT), device="cpu"),
                gal_els=gal_els, arrays=arrays, scales=scales)


def _carried_keys(r):
    a = r["arrays"]
    return interop.evaluation_key_set_from_numpy("cpu", galois_keys={
        g: (a[f"gk/{g}/q"], a[f"gk/{g}/p"]) for g in r["gal_els"]})


def _check(r, name, op, ev, ct):
    a = r["arrays"]
    for k, out in op(ev, ct).items():
        assert out.scale == r["scales"][f"{name}/{k}"]
        np.testing.assert_array_equal(interop.to_numpy(out.value), a[f"{name}/{k}"])


@pytest.mark.parametrize("name", list(CKKS_OPS))
def test_ckks_rotation_bit_equal(ref, name):
    ev = tckks.Evaluator(ref["pt"], _carried_keys(ref))
    ct = interop.ciphertext_from_numpy(ref["arrays"]["ct"], "cpu",
                                       scale=ref["pt"].default_scale_fraction)
    _check(ref, name, CKKS_OPS[name], ev, ct)


@pytest.mark.parametrize("name", list(BGV_OPS))
def test_bgv_rotation_bit_equal(ref_bgv, name):
    ev = tbgv.Evaluator(ref_bgv["pt"], _carried_keys(ref_bgv))
    ct = interop.ciphertext_from_numpy(ref_bgv["arrays"]["ct"], "cpu", scale=1)
    _check(ref_bgv, name, BGV_OPS[name], ev, ct)


def test_galois_element_lists(ref):
    tev, jev = tckks.Evaluator(ref["pt"]), jckks.Evaluator(ref["pj"])
    for batch, n in ((1, 1), (2, 5), (-2, 5), (3, 7), (4, 8)):
        assert (tev.galois_elements_for_inner_sum(batch, n)
                == jev.galois_elements_for_inner_sum(batch, n))
    for start in (0, 3, LOG_N - 1):
        assert tev.galois_elements_for_trace(start) == jev.galois_elements_for_trace(start)
    assert (tev.galois_elements_for_partial_traces_sum(3, 4)
            == jev.galois_elements_for_partial_traces_sum(3, 4))
    with pytest.raises(ValueError):
        tev.partial_traces_sum(None, 0, 2)


def test_carried_level_scoped_key_shape(ref):
    pt = ref["pt"]
    gk = _carried_keys(ref).galois_key(pt.galois_element(SCOPED_K))
    assert tuple(gk.gadget.value.q.shape) == (SCOPED_LEVEL + 1, 2, SCOPED_LEVEL + 1, pt.n)
    ct = interop.ciphertext_from_numpy(ref["arrays"]["ct"], "cpu")
    ev = tckks.Evaluator(pt, _carried_keys(ref))
    with pytest.raises(ValueError, match="generated at level"):
        ev.rotate(ct, SCOPED_K)      # a level-1 key used at level 2


# -- the port's own Galois keys -------------------------------------------------

@pytest.fixture(scope="module")
def own():
    params = tckks.Parameters(tckks.ParametersLiteral(**CKKS_LIT), device="cpu")
    gen = torch.Generator().manual_seed(9)
    kg = trlwe.KeyGenerator(params)
    sk = kg.gen_secret_key(gen)
    ev0 = tckks.Evaluator(params)
    els = _ckks_gal_els(ev0, params)
    scoped = params.galois_element(SCOPED_K)
    gks = kg.gen_galois_keys(gen, els, sk, chunk=3, levels={scoped: SCOPED_LEVEL})
    enc = tckks.Encoder(params)
    rng = np.random.default_rng(10)
    v = rng.uniform(-1, 1, params.max_slots) + 1j * rng.uniform(-1, 1, params.max_slots)
    ct = trlwe.Encryptor(params, sk).encrypt(gen, enc.encode(v))
    return dict(params=params, gks=gks, els=els, scoped=scoped, v=v, ct=ct,
                ev=tckks.Evaluator(params, trlwe.EvaluationKeySet(galois_keys=gks)),
                dec=lambda c: enc.decode(trlwe.Decryptor(params, sk).decrypt(c)))


def test_own_galois_keys_shapes(own):
    p = own["params"]
    assert sorted(own["gks"]) == sorted(own["els"])
    for g, gk in own["gks"].items():
        lvl = SCOPED_LEVEL if g == own["scoped"] else p.max_level
        assert gk.gal_el == g
        assert tuple(gk.gadget.value.q.shape) == (lvl + 1, 2, lvl + 1, p.n)
        assert tuple(gk.gadget.value.p.shape) == (lvl + 1, 2, 1, p.n)


@pytest.mark.parametrize("case, floor", [
    ("rotate", 28.0), ("conjugate", 28.0), ("rotate_hoisted", 28.0),
    ("inner_sum", 20.0), ("replicate", 20.0), ("level_scoped", 28.0)])
def test_own_keys_precision(own, case, floor):
    ev, ct, v = own["ev"], own["ct"], own["v"]
    if case == "rotate_hoisted":
        outs = ev.rotate_hoisted(ct, [0, 1, 7])
        for k, out in outs.items():
            tckks.verify_test_vectors(np.roll(v, -k), own["dec"](out), floor)
        return
    out, want = {
        "rotate": lambda: (ev.rotate(ct, -3), np.roll(v, 3)),
        "conjugate": lambda: (ev.conjugate(ct), np.conj(v)),
        "inner_sum": lambda: (ev.inner_sum(ct, 2, 5),
                              sum(np.roll(v, -2 * i) for i in range(5))),
        "replicate": lambda: (ev.replicate(ct, 2, 5),
                              sum(np.roll(v, 2 * i) for i in range(5))),
        "level_scoped": lambda: (ev.rotate(ct.at_level(SCOPED_LEVEL), SCOPED_K),
                                 np.roll(v, -SCOPED_K)),
    }[case]()
    tckks.verify_test_vectors(want, own["dec"](out), floor)


def test_own_keys_traces(own):
    """trace(·, logn) decrypts to the mean of the slots' rotations by
    multiples of 2^logn (the projection onto the sub-ring: its
    (N/n)^{-1} pre-multiplication cancels the n terms exactly);
    partial_traces_sum to the sum of the rotations by i·offset."""
    ev, ct, v = own["ev"], own["ct"], own["v"]
    step = 1 << (LOG_N - 3)
    want = sum(np.roll(v, -step * j) for j in range(v.size // step)) / (v.size // step)
    tckks.verify_test_vectors(want, own["dec"](ev.trace(ct, LOG_N - 3)), 25.0)
    want = sum(np.roll(v, -3 * i) for i in range(4))
    tckks.verify_test_vectors(want, own["dec"](ev.partial_traces_sum(ct, 3, 4)), 20.0)
