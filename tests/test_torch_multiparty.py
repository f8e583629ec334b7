"""Port parity for the multiparty protocols and thresholdization.

Every protocol of ``lattigo_tpu_torch.multiparty.protocols`` (CRPs,
collective public key, CKS, PCKS, Galois, evaluation and two-round
relinearization keys) and ``multiparty.threshold`` (Shamir polynomials,
Horner shares, Lagrange recombination) against ``lattigo_tpu`` on the CPU,
piece by piece: each ``gen_share``, ``aggregate_shares``, ``finalize`` /
``key_switch`` bit-equal (tolerance 0). ``jax.random`` draws cannot be
reproduced in torch, so the samplers each ``gen_share`` calls are patched
on both sides to read the same numpy draws, in call order; CRPs, Horner
and the Combiner need no patch. Two chains: 28-bit primes (4 Q + 2 P) at
logN 11, and the JAX package's own multiparty test chain at logN 10. Then
the whole multiparty path of ``chip_smoke.py`` (phase 6) runs in the port
alone at logN 12 on the four-step engine's plain version and decrypts to
the exact BGV slots, and its CKKS refresh to the 12-bit floor of
``tests/test_masked_transform.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from test_torch_keyed_prng import assert_same, shared_draws

from lattigo_tpu import multiparty as jmp, rlwe as jrlwe
from lattigo_tpu.multiparty import sharing_bgv as jshb
from lattigo_tpu.ring.ringqp import QPPoly as JQPPoly
from lattigo_tpu.rlwe.keys import compress_gadget as jcompress_gadget
from lattigo_tpu.schemes import bgv as jbgv
from lattigo_tpu_torch import interop, multiparty as tmp, rlwe as trlwe
from lattigo_tpu_torch.multiparty import sharing_bgv as tshb
from lattigo_tpu_torch.ring.ringqp import QPPoly as tmp_qp
from lattigo_tpu_torch.schemes import bgv as tbgv

N_PARTIES = 3
POINTS, THRESHOLD, ACTIVE = (1, 2, 3, 4), 3, (1, 2, 4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here, and
    they crowd the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_qp(j, t):
    """A JAX QPPoly (or list / tuple of them) equals the port's."""
    if not hasattr(j, "q"):                           # a list / tuple of them
        assert len(j) == len(t)
        for a, b in zip(j, t):
            assert_qp(a, b)
        return
    assert_same(j.q, t.q)
    assert (j.p is None) == (t.p is None)
    if j.p is not None:
        assert_same(j.p, t.p)


KEY = jax.random.PRNGKey(0)
GEN = torch.Generator().manual_seed(0)

CHAINS = {
    "28bit": dict(log_n=11, log_q=(28,) * 4, log_p=(28, 28), t=65537),
    "jax-tests": dict(log_n=10, log_q=(45, 35, 35), log_p=(50,), t=65537),
}


def _aggregate(proto, shares):
    agg = shares[0]
    for s in shares[1:]:
        agg = proto.aggregate_shares(agg, s)
    return agg


def _jsk(sk):
    return jrlwe.SecretKey(JQPPoly(jnp.asarray(interop.to_numpy(sk.value.q)),
                                   jnp.asarray(interop.to_numpy(sk.value.p))))


@pytest.fixture(scope="module", params=list(CHAINS))
def ctx(request):
    lit = CHAINS[request.param]
    pj = jbgv.Parameters(jbgv.ParametersLiteral(**lit))
    pt = tbgv.Parameters(tbgv.ParametersLiteral(**lit), device="cpu")
    rng = np.random.default_rng(3)
    coeffs = [rng.integers(-1, 2, pt.n) for _ in range(2 * N_PARTIES)]
    kt = trlwe.KeyGenerator(pt)
    st = [kt.secret_key_from_signed(torch.from_numpy(c)) for c in coeffs]
    sj = [_jsk(s) for s in st]
    ideal = st[0]
    for s in st[1:N_PARTIES]:
        ideal = trlwe.SecretKey(pt.ring_qp.add(ideal.value, s.value))
    enc = tbgv.Encoder(pt)
    m = rng.integers(0, pt.t, (2, pt.n))
    pt_value = enc.encode(m).value
    with shared_draws(4):
        cj = jrlwe.Encryptor(pj, _jsk(ideal)).encrypt(
            KEY, jrlwe.Plaintext(value=jnp.asarray(interop.to_numpy(pt_value)), scale=1),
            batch=(2,))
        ct = trlwe.Encryptor(pt, ideal).encrypt(
            GEN, trlwe.Plaintext(value=pt_value, scale=1), batch=(2,))
    assert_same(cj.value, ct.value)
    # the JAX protocols take one ciphertext (their draws have no batch axis)
    return dict(pj=pj, pt=pt, sj=sj[:N_PARTIES], st=st[:N_PARTIES],
                sj_out=sj[N_PARTIES:], st_out=st[N_PARTIES:], ideal=ideal,
                enc=enc, m=m, cj=cj.replace(value=cj.value[0]),
                ct=ct.replace(value=ct.value[0]), ct_batch=ct)


def test_crps(ctx):
    pj, pt = ctx["pj"], ctx["pt"]
    for count in (1, 3):
        assert_qp(jmp.sample_crp_qp(pj, b"crs", count), tmp.sample_crp_qp(pt, b"crs", count))
    for cls in ("GaloisKeyGenProtocol", "EvaluationKeyGenProtocol",
                "RelinearizationKeyGenProtocol"):
        a, b = getattr(jmp, cls)(pj), getattr(tmp, cls)(pt)
        assert a.num_digits() == b.num_digits()
        assert_qp(a.sample_crp(b"gadget-crs"), b.sample_crp(b"gadget-crs"))
    assert_same(jshb.BGVShareToEncProtocol(pj).sample_crp(b"s2e", 1),
                tshb.BGVShareToEncProtocol(pt).sample_crp(b"s2e", 1))


def _run_both(ctx, seed, fj, ft):
    """fj(jax sk, i) and ft(port sk, i) for every party under shared draws."""
    with shared_draws(seed):
        sh_j = [fj(s, i) for i, s in enumerate(ctx["sj"])]
        sh_t = [ft(s, i) for i, s in enumerate(ctx["st"])]
    return sh_j, sh_t


def test_collective_public_key(ctx):
    pj, pt = ctx["pj"], ctx["pt"]
    a, b = jmp.PublicKeyGenProtocol(pj), tmp.PublicKeyGenProtocol(pt)
    crp_j, crp_t = a.sample_crp(b"cpk"), b.sample_crp(b"cpk")
    sh_j, sh_t = _run_both(ctx, 5, lambda s, i: a.gen_share(KEY, s, crp_j),
                           lambda s, i: b.gen_share(GEN, s, crp_t))
    assert_qp(sh_j, sh_t)
    agg_j, agg_t = _aggregate(a, sh_j), _aggregate(b, sh_t)
    assert_qp(agg_j, agg_t)
    pk_j, pk_t = a.finalize(agg_j, crp_j), b.finalize(agg_t, crp_t)
    assert_qp(pk_j.value, pk_t.value)
    # the port's own pk encryption under it decrypts under Σ s_i
    enc = ctx["enc"]
    c = trlwe.Encryptor(pt, pk_t).encrypt(GEN, enc.encode(ctx["m"]), batch=(2,))
    got = enc.decode(trlwe.Decryptor(pt, ctx["ideal"]).decrypt(c))
    np.testing.assert_array_equal(got, ctx["m"])


@pytest.mark.parametrize("to_zero", [True, False])
def test_collective_key_switch(ctx, to_zero):
    """CKS to 0 (collective decryption) and to another shared key."""
    pj, pt = ctx["pj"], ctx["pt"]
    a, b = jmp.KeySwitchProtocol(pj), tmp.KeySwitchProtocol(pt)
    out_j = [None] * N_PARTIES if to_zero else ctx["sj_out"]
    out_t = [None] * N_PARTIES if to_zero else ctx["st_out"]
    sh_j, sh_t = _run_both(ctx, 6, lambda s, i: a.gen_share(KEY, s, out_j[i], ctx["cj"]),
                           lambda s, i: b.gen_share(GEN, s, out_t[i], ctx["ct"]))
    for x, y in zip(sh_j, sh_t):
        assert_same(x, y)
    agg_j, agg_t = _aggregate(a, sh_j), _aggregate(b, sh_t)
    assert_same(agg_j, agg_t)
    res_j, res_t = a.key_switch(ctx["cj"], agg_j), b.key_switch(ctx["ct"], agg_t)
    assert_same(res_j.value, res_t.value)
    if to_zero:
        got = ctx["enc"].decode(trlwe.Plaintext(value=res_t.value[0]))
        np.testing.assert_array_equal(got, ctx["m"][0])


def test_collective_key_switch_batch(ctx):
    """A batch of ciphertexts: each gets its own flooding noise, and the
    collective decryption of the batch is exact."""
    pt = ctx["pt"]
    b = tmp.KeySwitchProtocol(pt)
    cb = ctx["ct_batch"]
    g = torch.Generator().manual_seed(7)
    sh = [b.gen_share(g, s, None, cb) for s in ctx["st"]]
    assert sh[0].shape == cb.value[..., 0, :, :].shape
    e = pt.ring_q.sub(sh[0], pt.ring_q.mul_mont(cb.value[:, 1], ctx["st"][0].value.q))
    assert not torch.equal(e[0], e[1])
    res = b.key_switch(cb, _aggregate(b, sh))
    got = ctx["enc"].decode(trlwe.Plaintext(value=res.value[:, 0]))
    np.testing.assert_array_equal(got, ctx["m"])


def test_public_key_switch(ctx):
    pj, pt = ctx["pj"], ctx["pt"]
    sk_r = ctx["st_out"][0]
    with shared_draws(8):
        pk_j = jrlwe.KeyGenerator(pj).gen_public_key(KEY, ctx["sj_out"][0])
        pk_t = trlwe.KeyGenerator(pt).gen_public_key(GEN, sk_r)
    assert_qp(pk_j.value, pk_t.value)
    a, b = jmp.PublicKeySwitchProtocol(pj), tmp.PublicKeySwitchProtocol(pt)
    sh_j, sh_t = _run_both(ctx, 9, lambda s, i: a.gen_share(KEY, s, pk_j, ctx["cj"]),
                           lambda s, i: b.gen_share(GEN, s, pk_t, ctx["ct"]))
    for x, y in zip(sh_j, sh_t):
        assert_same(x[0], y[0])
        assert_same(x[1], y[1])
    agg_j, agg_t = _aggregate(a, sh_j), _aggregate(b, sh_t)
    res_j, res_t = a.key_switch(ctx["cj"], agg_j), b.key_switch(ctx["ct"], agg_t)
    assert_same(res_j.value, res_t.value)
    got = ctx["enc"].decode(trlwe.Decryptor(pt, sk_r).decrypt(res_t))
    np.testing.assert_array_equal(got, ctx["m"][0])


def test_collective_galois_key(ctx):
    pj, pt = ctx["pj"], ctx["pt"]
    gal = pt.galois_element(1)
    a, b = jmp.GaloisKeyGenProtocol(pj), tmp.GaloisKeyGenProtocol(pt)
    crp_j, crp_t = a.sample_crp(b"gk"), b.sample_crp(b"gk")
    sh_j, sh_t = _run_both(ctx, 10, lambda s, i: a.gen_share(KEY, gal, s, crp_j),
                           lambda s, i: b.gen_share(GEN, gal, s, crp_t))
    assert_qp(sh_j, sh_t)
    agg_j, agg_t = _aggregate(a, sh_j), _aggregate(b, sh_t)
    gk_j, gk_t = a.finalize(gal, agg_j, crp_j), b.finalize(gal, agg_t, crp_t)
    assert_qp(gk_j.gadget.value, gk_t.gadget.value)
    assert gk_t.gal_el == gk_j.gal_el == gal
    ev = tbgv.Evaluator(pt, trlwe.EvaluationKeySet(galois_keys={gal: gk_t}))
    got = ctx["enc"].decode(trlwe.Decryptor(pt, ctx["ideal"]).decrypt(
        ev.rotate_columns(ctx["ct"], 1)))
    h = pt.n // 2
    m = ctx["m"][0]
    np.testing.assert_array_equal(got, np.concatenate([np.roll(m[:h], -1),
                                                       np.roll(m[h:], -1)]))


def test_collective_evaluation_key(ctx):
    pj, pt = ctx["pj"], ctx["pt"]
    a, b = jmp.EvaluationKeyGenProtocol(pj), tmp.EvaluationKeyGenProtocol(pt)
    crp_j, crp_t = a.sample_crp(b"evk"), b.sample_crp(b"evk")
    sh_j, sh_t = _run_both(
        ctx, 11, lambda s, i: a.gen_share(KEY, s, ctx["sj_out"][i], crp_j),
        lambda s, i: b.gen_share(GEN, s, ctx["st_out"][i], crp_t))
    assert_qp(sh_j, sh_t)
    evk_j = a.finalize(_aggregate(a, sh_j), crp_j)
    evk_t = b.finalize(_aggregate(b, sh_t), crp_t)
    assert_qp(evk_j.gadget.value, evk_t.gadget.value)
    out = trlwe.Evaluator(pt).apply_evaluation_key(ctx["ct"], evk_t)
    ideal_out = ctx["st_out"][0]
    for s in ctx["st_out"][1:]:
        ideal_out = trlwe.SecretKey(pt.ring_qp.add(ideal_out.value, s.value))
    got = ctx["enc"].decode(trlwe.Decryptor(pt, ideal_out).decrypt(out))
    np.testing.assert_array_equal(got, ctx["m"][0])


def test_collective_relinearization_key(ctx):
    pj, pt = ctx["pj"], ctx["pt"]
    a, b = jmp.RelinearizationKeyGenProtocol(pj), tmp.RelinearizationKeyGenProtocol(pt)
    crp_j, crp_t = a.sample_crp(b"rlk"), b.sample_crp(b"rlk")
    eph_j, eph_t = _run_both(ctx, 12, lambda s, i: a.gen_ephemeral(KEY),
                             lambda s, i: b.gen_ephemeral(GEN))
    assert_qp([e.value for e in eph_j], [e.value for e in eph_t])
    r1_j, r1_t = _run_both(ctx, 13, lambda s, i: a.gen_share_round1(KEY, s, eph_j[i], crp_j),
                           lambda s, i: b.gen_share_round1(GEN, s, eph_t[i], crp_t))
    assert_qp(r1_j, r1_t)
    agg1_j, agg1_t = _aggregate(a, r1_j), _aggregate(b, r1_t)
    assert_qp(agg1_j, agg1_t)
    r2_j, r2_t = _run_both(ctx, 14, lambda s, i: a.gen_share_round2(KEY, s, eph_j[i], agg1_j),
                           lambda s, i: b.gen_share_round2(GEN, s, eph_t[i], agg1_t))
    assert_qp(r2_j, r2_t)
    agg2_j, agg2_t = _aggregate(a, r2_j), _aggregate(b, r2_t)
    rlk_j, rlk_t = a.finalize(agg1_j, agg2_j), b.finalize(agg1_t, agg2_t)
    assert_qp(rlk_j.gadget.value, rlk_t.gadget.value)
    ev = tbgv.Evaluator(pt, trlwe.EvaluationKeySet(rlk_t))
    out = ev.rescale(ev.mul_relin(ctx["ct"], ctx["ct"]))
    got = ctx["enc"].decode(trlwe.Decryptor(pt, ctx["ideal"]).decrypt(out))
    np.testing.assert_array_equal(got, ctx["m"][0] ** 2 % pt.t)


def test_threshold(ctx):
    """4 parties Shamir-share their keys (threshold 3); the Horner shares,
    their sums and the active set {1, 2, 4}'s additive shares are
    bit-equal, and the additive shares sum to the parties' whole key."""
    pj, pt = ctx["pj"], ctx["pt"]
    sj = ctx["sj"] + ctx["sj_out"][:1]
    st = ctx["st"] + ctx["st_out"][:1]
    tj, tt = jmp.Thresholdizer(pj), tmp.Thresholdizer(pt)
    with shared_draws(15):
        polys_j = [tj.gen_shamir_polynomial(KEY, THRESHOLD, s) for s in sj]
        polys_t = [tt.gen_shamir_polynomial(GEN, THRESHOLD, s) for s in st]
    for a, b in zip(polys_j, polys_t):
        assert_qp(a.coeffs, b.coeffs)
    shares_j, shares_t = [], []
    for x in POINTS:
        parts_j = [tj.gen_shamir_secret_share(x, p) for p in polys_j]
        parts_t = [tt.gen_shamir_secret_share(x, p) for p in polys_t]
        assert_qp(parts_j, parts_t)
        acc_j, acc_t = parts_j[0], parts_t[0]
        for a, b in zip(parts_j[1:], parts_t[1:]):
            acc_j = jmp.Thresholdizer.aggregate_shares(pj, acc_j, a)
            acc_t = tmp.Thresholdizer.aggregate_shares(pt, acc_t, b)
        shares_j.append(acc_j)
        shares_t.append(acc_t)
    assert_qp(shares_j, shares_t)
    cj, ct = jmp.Combiner(pj, THRESHOLD), tmp.Combiner(pt, THRESHOLD)
    add_t = []
    for x in ACTIVE:
        a = cj.gen_additive_share(list(ACTIVE), x, shares_j[x - 1])
        b = ct.gen_additive_share(list(ACTIVE), x, shares_t[x - 1])
        assert_qp(a.value, b.value)
        add_t.append(b)
    whole, rec = st[0].value, add_t[0].value
    for s in st[1:]:
        whole = pt.ring_qp.add(whole, s.value)
    for s in add_t[1:]:
        rec = pt.ring_qp.add(rec, s.value)
    assert torch.equal(rec.q, whole.q) and torch.equal(rec.p, whole.p)
    with pytest.raises(ValueError):
        ct.gen_additive_share([1, 2], 1, shares_t[0])


def test_multiparty_path_of_chip_smoke():
    """chip_smoke.py phase 6 in the port alone at logN 12 on the CPU (the
    four-step engine's plain version): every BGV check inside is exact;
    the CKKS refresh decodes at the 12-bit floor."""
    import chip_smoke
    res = chip_smoke.mp_flow("cpu", 12, 218, lambda label, fn: fn())
    assert res["params"].ring_q.ntt_engine == "mxu-plain"
    assert res["cparams"].ring_q.ntt_engine == "mxu-plain"
    assert (res["refresh_level"], res["refresh_log_bound"]) == (1, 40)
    assert res["ckks_stats"].min_precision >= 12.0


def _np_tree(x):
    """A JAX share (QPPoly NamedTuples, lists, tuples) as the same structure
    with the port's QPPoly holding numpy arrays."""
    if hasattr(x, "q"):
        return tmp_qp(np.asarray(x.q), None if x.p is None else np.asarray(x.p))
    if isinstance(x, (list, tuple)):
        return type(x)(_np_tree(y) for y in x)
    return np.asarray(x)


def test_interop_carries_keys_and_shares(ctx):
    """JAX shares, keys and Shamir polynomials carried into the port: the
    port aggregates and finalizes them to the JAX package's keys, and its
    shares carried back are the same arrays. (The JAX side draws from the
    patched samplers, so no jax.random program is compiled.)"""
    pj, pt = ctx["pj"], ctx["pt"]
    a, b = jmp.RelinearizationKeyGenProtocol(pj), tmp.RelinearizationKeyGenProtocol(pt)
    crps = a.sample_crp(b"rlk")
    kg = jrlwe.KeyGenerator(pj)
    cpk = jmp.PublicKeyGenProtocol(pj)
    crp = cpk.sample_crp(b"cpk")
    with shared_draws(30):
        eph = [a.gen_ephemeral(KEY) for _ in ctx["sj"]]
        r1 = [a.gen_share_round1(KEY, s, u, crps) for s, u in zip(ctx["sj"], eph)]
        agg1_j = _aggregate(a, r1)
        r2 = [a.gen_share_round2(KEY, s, u, agg1_j) for s, u in zip(ctx["sj"], eph)]
        pk_j = cpk.finalize(_aggregate(cpk, [cpk.gen_share(KEY, s, crp)
                                             for s in ctx["sj"]]), crp)
        evk = kg.gen_evaluation_key(KEY, ctx["sj"][0], ctx["sj"][1])
        g = kg.gadget_encrypt(KEY, ctx["sj"][1].value.q, ctx["sj"][0], seed=b"cg")
        poly = jmp.Thresholdizer(pj).gen_shamir_polynomial(KEY, THRESHOLD, ctx["sj"][0])
    r1_t = [interop.share_from_numpy(_np_tree(x), "cpu") for x in r1]
    assert isinstance(r1_t[0], list) and isinstance(r1_t[0][0], tuple)
    agg1_t = _aggregate(b, r1_t)
    assert_qp(agg1_j, agg1_t)
    assert_qp(agg1_j, interop.share_to_numpy(agg1_t))
    agg2_t = _aggregate(b, [interop.share_from_numpy(_np_tree(x), "cpu") for x in r2])
    rlk_j = a.finalize(agg1_j, _aggregate(a, r2))
    assert_qp(rlk_j.gadget.value, b.finalize(agg1_t, agg2_t).gadget.value)

    pk_t = interop.public_key_from_numpy(np.asarray(pk_j.value.q),
                                         np.asarray(pk_j.value.p), "cpu")
    enc = ctx["enc"]
    c = trlwe.Encryptor(pt, pk_t).encrypt(GEN, enc.encode(ctx["m"][0]))
    np.testing.assert_array_equal(
        enc.decode(trlwe.Decryptor(pt, ctx["ideal"]).decrypt(c)), ctx["m"][0])
    evk_t = interop.evaluation_key_from_numpy(np.asarray(evk.gadget.value.q),
                                              np.asarray(evk.gadget.value.p), "cpu")
    assert_qp(evk.gadget.value, evk_t.gadget.value)
    cg = jcompress_gadget(g, b"cg")
    cg_t = interop.compressed_gadget_from_numpy(np.asarray(cg.c0.q), np.asarray(cg.c0.p),
                                                cg.seed, "cpu")
    assert_qp(g.value, cg_t.expand(pt).value)
    poly_t = interop.shamir_polynomial_from_numpy(
        [(np.asarray(c.q), np.asarray(c.p)) for c in poly.coeffs], "cpu")
    assert_qp(jmp.Thresholdizer(pj).gen_shamir_secret_share(3, poly),
              tmp.Thresholdizer(pt).gen_shamir_secret_share(3, poly_t))
