"""Port parity for encryption ↔ share conversion and collective refresh.

``lattigo_tpu_torch.multiparty.sharing_bgv`` (BGV E2S / S2E, masked
transform, refresh over R_T masks) and ``multiparty.sharing`` (the CKKS
E2S / S2E with flooding masks, ``lift_public``, the masked transform with
and without a parameter switch, ``get_minimum_level_for_refresh``) against
``lattigo_tpu`` on the CPU. ``jax.random`` draws cannot be reproduced in
torch, so every sampler the protocols call (the small signed samplers,
uniform residues and the two mask samplers) is patched on both sides to
read the same numpy draws, in call order; everything else is bit-equal as
it stands (tolerance 0). Decryptions are checked against numpy (BGV,
exact) or at the precision floor of ``tests/test_masked_transform.py``
(CKKS, 12 bits). The port refuses the reference's int64 wrap of an
up-scaled mask (its known caveat 2): that is pinned too.
"""

from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from test_torch_keyed_prng import assert_same, shared_draws

from lattigo_tpu import rlwe as jrlwe
from lattigo_tpu.multiparty import sharing as jsh, sharing_bgv as jshb
from lattigo_tpu.ring.ringqp import QPPoly as JQPPoly
from lattigo_tpu.schemes import bgv as jbgv, ckks as jckks
from lattigo_tpu_torch import interop, rlwe as trlwe
from lattigo_tpu_torch.multiparty import (
    additive_shares as tadd, sharing as tsh, sharing_bgv as tshb,
)
from lattigo_tpu_torch.schemes import bgv as tbgv, ckks as tckks

N_PARTIES = 3


KEY = jax.random.PRNGKey(0)
GEN = torch.Generator().manual_seed(0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here, and
    they crowd the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(pj, pt, seed):
    """Party secret keys from shared ternary coefficients, both packages,
    and the ideal key Σ s_i."""
    rng = np.random.default_rng(seed)
    coeffs = [rng.integers(-1, 2, pj.n) for _ in range(N_PARTIES)]
    kj, kt = jrlwe.KeyGenerator(pj), trlwe.KeyGenerator(pt)
    sj = [kj.secret_key_from_signed(jnp.asarray(c)) for c in coeffs]
    st = [kt.secret_key_from_signed(torch.from_numpy(c)) for c in coeffs]
    ideal = st[0]
    for s in st[1:]:
        ideal = trlwe.SecretKey(pt.ring_qp.add(ideal.value, s.value))
    return sj, st, ideal


def _encrypt_both(pj, pt, sk_t, pt_value, level):
    """The same plaintext encrypted under the ideal key on both sides (the
    draws shared), cut to ``level``."""
    jsk = jrlwe.SecretKey(JQPPoly(jnp.asarray(interop.to_numpy(sk_t.value.q)),
                                  jnp.asarray(interop.to_numpy(sk_t.value.p))))
    cj = jrlwe.Encryptor(pj, jsk).encrypt(
        KEY, jrlwe.Plaintext(value=jnp.asarray(interop.to_numpy(pt_value)))).at_level(level)
    ct = trlwe.Encryptor(pt, sk_t).encrypt(
        GEN, trlwe.Plaintext(value=pt_value)).at_level(level)
    return cj, ct


def _aggregate(proto, shares):
    agg = shares[0]
    for s in shares[1:]:
        agg = proto.aggregate_shares(agg, s)
    return agg


# -- BGV ------------------------------------------------------------------------

BGV_CHAINS = {
    "28bit": dict(log_n=11, log_q=(28,) * 4, log_p=(28, 28), t=65537),
    "jax-tests": dict(log_n=9, log_q=(45, 35, 35), log_p=(50,), t=65537),
}


@pytest.fixture(scope="module", params=list(BGV_CHAINS))
def bgv_ctx(request):
    lit = BGV_CHAINS[request.param]
    pj = jbgv.Parameters(jbgv.ParametersLiteral(**lit))
    pt = tbgv.Parameters(tbgv.ParametersLiteral(**lit), device="cpu")
    sj, st, ideal = _keys(pj, pt, 5)
    enc = tbgv.Encoder(pt)
    m = np.random.default_rng(6).integers(0, pt.t, pt.n)
    with shared_draws(7):
        cj, ct = _encrypt_both(pj, pt, ideal, enc.encode(m).value, 0)
    assert_same(cj.value, ct.value)
    return dict(pj=pj, pt=pt, sj=sj, st=st, ideal=ideal, enc=enc, m=m, cj=cj, ct=ct)


def _bgv_run(c, proto_j, proto_t, transform_j=None, transform_t=None):
    pj, pt = c["pj"], c["pt"]
    L = pt.max_level
    kw_j = {} if transform_j is None else {"transform": transform_j}
    kw_t = {} if transform_t is None else {"transform": transform_t}
    crp_j = proto_j.sample_crp(b"bgv-refresh-crs", L)
    crp_t = proto_t.sample_crp(b"bgv-refresh-crs", L)
    assert_same(crp_j, crp_t)
    with shared_draws(8):
        sh_j = [proto_j.gen_share(KEY, s, c["cj"], crp_j, level_out=L, **kw_j)
                for s in c["sj"]]
        sh_t = [proto_t.gen_share(GEN, s, c["ct"], crp_t, level_out=L, **kw_t)
                for s in c["st"]]
    for a, b in zip(sh_j, sh_t):
        assert_same(a[0], b[0])
        assert_same(a[1], b[1])
    agg_j, agg_t = _aggregate(proto_j, sh_j), _aggregate(proto_t, sh_t)
    assert_same(agg_j[0], agg_t[0])
    assert_same(agg_j[1], agg_t[1])
    out_j = proto_j.finalize(c["cj"], agg_j, crp_j, level_out=L, **kw_j)
    out_t = proto_t.finalize(c["ct"], agg_t, crp_t, level_out=L, **kw_t)
    assert_same(out_j.value, out_t.value)
    assert out_t.level == L and out_t.scale == out_j.scale
    return out_t


def test_bgv_refresh(bgv_ctx):
    c = bgv_ctx
    out = _bgv_run(c, jshb.BGVRefreshProtocol(c["pj"]), tshb.BGVRefreshProtocol(c["pt"]))
    got = c["enc"].decode(trlwe.Decryptor(c["pt"], c["ideal"]).decrypt(out))
    np.testing.assert_array_equal(got, c["m"])


def test_bgv_masked_transform(bgv_ctx):
    """×3 and a rotation by one slot, riding the refresh (decode + encode)."""
    c = bgv_ctx
    t = c["pt"].t

    def fn(vals):
        return np.roll((vals.astype(object) * 3) % t, 1).astype(np.uint64)

    out = _bgv_run(c, jshb.BGVMaskedTransformProtocol(c["pj"]),
                   tshb.BGVMaskedTransformProtocol(c["pt"]),
                   jshb.MaskedTransformFunc(fn, decode=True, encode=True),
                   tshb.MaskedTransformFunc(fn, decode=True, encode=True))
    got = c["enc"].decode(trlwe.Decryptor(c["pt"], c["ideal"]).decrypt(out))
    np.testing.assert_array_equal(got, fn(c["m"].astype(np.uint64)).astype(np.int64))


def test_bgv_masked_transform_on_coefficients(bgv_ctx):
    """A transform on the raw R_T coefficients (no decode / encode)."""
    c = bgv_ctx
    t = c["pt"].t

    def fn(vals):
        return (vals.astype(object) * 5 % t).astype(np.uint64)

    out = _bgv_run(c, jshb.BGVMaskedTransformProtocol(c["pj"]),
                   tshb.BGVMaskedTransformProtocol(c["pt"]),
                   jshb.MaskedTransformFunc(fn), tshb.MaskedTransformFunc(fn))
    got = c["enc"].decode(trlwe.Decryptor(c["pt"], c["ideal"]).decrypt(out))
    np.testing.assert_array_equal(got, c["m"] * 5 % t)


def test_bgv_enc_to_share_get_share(bgv_ctx):
    """E2S alone: the masked decryption plus each party's own mask sums
    to the message's R_T coefficients, bit-equal on both sides."""
    c = bgv_ctx
    pj, pt = c["pj"], c["pt"]
    ej, et = jshb.BGVEncToShareProtocol(pj), tshb.BGVEncToShareProtocol(pt)
    with shared_draws(9):
        sh_j = [ej.gen_share(KEY, s, c["cj"]) for s in c["sj"]]
        sh_t = [et.gen_share(GEN, s, c["ct"]) for s in c["st"]]
    for a, b in zip(sh_j, sh_t):
        assert_same(a[0], b[0])
        assert_same(a[1], b[1])
    agg_j = _aggregate(ej, [h for _, h in sh_j])
    agg_t = _aggregate(et, [h for _, h in sh_t])
    assert_same(agg_j, agg_t)
    parts_j = [ej.get_share(sh_j[0][0], agg_j, c["cj"])]
    parts_t = [et.get_share(sh_t[0][0], agg_t, c["ct"])]
    for (mj, _), (mt, _) in zip(sh_j[1:], sh_t[1:]):
        parts_j.append(mj)
        parts_t.append(mt)
    assert_same(parts_j[0], parts_t[0])
    total = parts_t[0]
    for x in parts_t[1:]:
        total = pt.ring_t.add(total, x)
    np.testing.assert_array_equal(c["enc"].decode_ring_t(total).numpy(), c["m"])


# -- CKKS -------------------------------------------------------------------------

CKKS_CHAINS = {
    "28bit": dict(log_n=11, log_q=(28,) * 4, log_p=(28, 28), log_default_scale=28),
    "jax-tests": dict(log_n=9, log_q=(55, 45, 45), log_p=(60,), log_default_scale=45),
}


@pytest.fixture(scope="module", params=list(CKKS_CHAINS))
def ckks_ctx(request):
    lit = CKKS_CHAINS[request.param]
    pj = jckks.Parameters(jckks.ParametersLiteral(**lit))
    pt = tckks.Parameters(tckks.ParametersLiteral(**lit), device="cpu")
    sj, st, ideal = _keys(pj, pt, 15)
    enc = tckks.Encoder(pt)
    rng = np.random.default_rng(16)
    v = rng.uniform(-1, 1, pt.max_slots) + 1j * rng.uniform(-1, 1, pt.max_slots)
    level = 1 if request.param == "28bit" else 0
    pt_v = enc.encode(v, level=level)
    with shared_draws(17):
        cj, ct = _encrypt_both(pj, pt, ideal, pt_v.value, level)
    cj, ct = cj.replace(scale=pt_v.scale), ct.replace(scale=pt_v.scale)
    assert_same(cj.value, ct.value)
    return dict(pj=pj, pt=pt, sj=sj, st=st, ideal=ideal, enc=enc, v=v,
                cj=cj, ct=ct, level=level)


def _ckks_decode(c, params, sk, ct, enc=None):
    enc = enc or c["enc"]
    return enc.decode(trlwe.Decryptor(params, sk).decrypt(ct))


def test_ckks_refresh(ckks_ctx):
    """E2S at the input level, lift_public, S2E at the top: every share,
    the lift and the refreshed ciphertext bit-equal; the refreshed
    ciphertext decodes at the 12-bit floor."""
    c = ckks_ctx
    pj, pt = c["pj"], c["pt"]
    L = pt.max_level
    rj, rt = jsh.RefreshProtocol(pj, log_bound=40), tsh.RefreshProtocol(pt, log_bound=40)
    crp_j = rj.s2e.sample_crp(b"refresh-crs", L)
    crp_t = rt.s2e.sample_crp(b"refresh-crs", L)
    assert_same(crp_j, crp_t)
    with shared_draws(18):
        e2s_j, s2e_j, e2s_t, s2e_t = [], [], [], []
        for s in c["sj"]:
            mask, h = rj.e2s.gen_share(KEY, s, c["cj"])
            e2s_j.append(h)
            s2e_j.append(rj.s2e.gen_share(KEY, s, mask, crp_j, L))
        for s in c["st"]:
            mask, h = rt.e2s.gen_share(GEN, s, c["ct"])
            e2s_t.append(h)
            s2e_t.append(rt.s2e.gen_share(GEN, s, mask, crp_t, L))
    for a, b in zip(e2s_j + s2e_j, e2s_t + s2e_t):
        assert_same(a, b)
    pub_j = rj.e2s.finalize_public(c["cj"], _aggregate(rj.e2s, e2s_j))
    pub_t = rt.e2s.finalize_public(c["ct"], _aggregate(rt.e2s, e2s_t))
    assert_same(pub_j, pub_t)
    lift_j = rj.lift_public(pub_j, c["level"], L)
    lift_t = rt.lift_public(pub_t, c["level"], L)
    assert_same(lift_j, lift_t)
    out_j = rj.s2e.finalize(_aggregate(rj.s2e, s2e_j), crp_j, extra_c0=lift_j,
                            scale=c["ct"].scale, level=L)
    out_t = rt.s2e.finalize(_aggregate(rt.s2e, s2e_t), crp_t, extra_c0=lift_t,
                            scale=c["ct"].scale, level=L)
    assert_same(out_j.value, out_t.value)
    assert out_t.level == L
    tckks.verify_test_vectors(c["v"], _ckks_decode(c, pt, c["ideal"], out_t), 12.0)


def _masked_run(c, proto_j, proto_t, tr_j, tr_t, sk_out=None):
    crp_j = proto_j.sample_crp(b"masked-transform-crs")
    crp_t = proto_t.sample_crp(b"masked-transform-crs")
    assert_same(crp_j, crp_t)
    so_j, so_t = sk_out or ([None] * N_PARTIES, [None] * N_PARTIES)
    with shared_draws(19):
        sh_j = [proto_j.gen_share(KEY, s, c["cj"], crp_j, tr_j, sk_out=o)
                for s, o in zip(c["sj"], so_j)]
        sh_t = [proto_t.gen_share(GEN, s, c["ct"], crp_t, tr_t, sk_out=o)
                for s, o in zip(c["st"], so_t)]
    for a, b in zip(sh_j, sh_t):
        assert_same(a[0], b[0])
        assert_same(a[1], b[1])
    out_j = proto_j.finalize(c["cj"], _aggregate(proto_j, sh_j), crp_j, tr_j)
    out_t = proto_t.finalize(c["ct"], _aggregate(proto_t, sh_t), crp_t, tr_t)
    assert_same(out_j.value, out_t.value)
    assert Fraction(out_t.scale) == Fraction(out_j.scale)
    return out_t


def test_ckks_masked_transform(ckks_ctx):
    c = ckks_ctx
    pj, pt = c["pj"], c["pt"]
    d = np.random.default_rng(20).uniform(-1, 1, pt.max_slots)
    tr_j = jsh.ckks_coeff_transform(jckks.Encoder(pj), lambda s: d * s)
    tr_t = tsh.ckks_coeff_transform(c["enc"], lambda s: d * s)
    out = _masked_run(c, jsh.MaskedTransformProtocol(pj, log_bound=40),
                      tsh.MaskedTransformProtocol(pt, log_bound=40), tr_j, tr_t)
    assert out.level == pt.max_level
    tckks.verify_test_vectors(d * c["v"], _ckks_decode(c, pt, c["ideal"], out), 12.0)


def _out_params(c, log_scale_out):
    lit = dict(CKKS_CHAINS["28bit" if c["pt"].log_n == 11 else "jax-tests"])
    lit.update(log_q=tuple(lit["log_q"]) + (lit["log_q"][-1],),
               log_default_scale=log_scale_out)
    return (jckks.Parameters(jckks.ParametersLiteral(**lit)),
            tckks.Parameters(tckks.ParametersLiteral(**lit), device="cpu"))


def _sk_out(c, po_j, po_t):
    rng = np.random.default_rng(15)                 # the coefficients of _keys
    coeffs = [rng.integers(-1, 2, po_t.n) for _ in range(N_PARTIES)]
    kj, kt = jrlwe.KeyGenerator(po_j), trlwe.KeyGenerator(po_t)
    sj = [kj.secret_key_from_signed(jnp.asarray(x)) for x in coeffs]
    st = [kt.secret_key_from_signed(torch.from_numpy(x)) for x in coeffs]
    ideal = st[0]
    for s in st[1:]:
        ideal = trlwe.SecretKey(po_t.ring_qp.add(ideal.value, s.value))
    return sj, st, ideal


@pytest.mark.parametrize("shift", [-3, 4])
def test_ckks_masked_transform_with_params(ckks_ctx, shift):
    """Re-encryption into another chain at a scale 2^shift times the
    input's: down (ratio < 1) and up (log_bound + log2(ratio) = 44 ≤ 62),
    bit-equal, decoding at the 12-bit floor under the output key."""
    c = ckks_ctx
    pj, pt = c["pj"], c["pt"]
    log_in = int(round(np.log2(float(c["ct"].scale))))
    po_j, po_t = _out_params(c, log_in + shift)
    sj, st, ideal_out = _sk_out(c, po_j, po_t)
    d = np.random.default_rng(21).uniform(-1, 1, pt.max_slots)
    tr_j = jsh.ckks_coeff_transform(jckks.Encoder(pj), lambda s: d * s)
    tr_t = tsh.ckks_coeff_transform(c["enc"], lambda s: d * s)
    out = _masked_run(c, jsh.MaskedTransformProtocol(pj, log_bound=40).with_params(po_j),
                      tsh.MaskedTransformProtocol(pt, log_bound=40).with_params(po_t),
                      tr_j, tr_t, sk_out=(sj, st))
    assert out.level == po_t.max_level
    assert Fraction(out.scale) == po_t.default_scale_fraction
    got = _ckks_decode(c, po_t, ideal_out, out, tckks.Encoder(po_t))
    tckks.verify_test_vectors(d * c["v"], got, 12.0)


def test_ckks_masked_transform_refuses_int64_wrap(ckks_ctx):
    """The reference's caveat 2: a 2^60 mask scaled up by 2^4 passes 62
    bits; the port raises before drawing anything instead of wrapping."""
    c = ckks_ctx
    log_in = int(round(np.log2(float(c["ct"].scale))))
    po_j, po_t = _out_params(c, log_in + 4)
    _, st_out, _ = _sk_out(c, po_j, po_t)
    proto = tsh.MaskedTransformProtocol(c["pt"], log_bound=60).with_params(po_t)
    crp = proto.sample_crp(b"x")
    before = GEN.get_state()
    with pytest.raises(ValueError, match="62 bits"):
        proto.gen_share(GEN, c["st"][0], c["ct"], crp, lambda x: x, sk_out=st_out[0])
    assert torch.equal(GEN.get_state(), before)
    # 58 + 4 = 62 is still carried
    ok = tsh.MaskedTransformProtocol(c["pt"], log_bound=58).with_params(po_t)
    h, h2 = ok.gen_share(GEN, c["st"][0], c["ct"], crp, lambda x: x, sk_out=st_out[0])
    assert h2.shape == (po_t.max_level + 1, po_t.n)


@pytest.mark.parametrize("lam, log_scale, parties, chain", [
    (128, 45, 3, (55, 45, 45, 45)), (12, 28, 3, (28,) * 13),
    (40, 28, 7, (28,) * 13), (128, 45, 3, (55, 45)), (1, 1, 1, (30,))])
def test_get_minimum_level_for_refresh(lam, log_scale, parties, chain):
    from lattigo_tpu_torch.utils.primes import NTTFriendlyPrimesGenerator
    moduli = [NTTFriendlyPrimesGenerator(b, 1 << 10).next_alternating_prime()
              for b in chain]
    assert (tsh.get_minimum_level_for_refresh(lam, 2.0 ** log_scale, parties, moduli)
            == jsh.get_minimum_level_for_refresh(lam, 2.0 ** log_scale, parties, moduli))
    if chain == (28,) * 13 and lam == 12:           # chip_smoke.py's refresh
        assert tsh.get_minimum_level_for_refresh(
            lam, Fraction(1 << log_scale), parties, moduli) == (1, 40, True)


def test_additive_shares():
    pt = tbgv.Parameters(tbgv.ParametersLiteral(**BGV_CHAINS["jax-tests"]), device="cpu")
    z = tadd.new_additive_share(pt.ring_q, 1, (2,))
    assert z.value.shape == (2, 2, pt.n) and not z.value.any()
    x = tadd.AdditiveShare(pt.ring_q.from_int_coeffs(range(pt.n), 1))
    y = tadd.AdditiveShare(pt.ring_q.from_int_coeffs([-i for i in range(pt.n)], 1))
    assert not x.aggregate(y, pt.ring_q, 1).value.any()
    b = tadd.new_additive_share_bigint(3).aggregate(tadd.AdditiveShareBigint([1, -2, 1 << 70]))
    assert b.value == [1, -2, 1 << 70]
    np.testing.assert_array_equal(
        tadd.AdditiveShareBigint([5, -7]).to_numpy_signed(), [5, -7])
    with pytest.raises(ValueError):
        b.aggregate(tadd.AdditiveShareBigint([1]))


# -- the precision floor of chip_smoke.py's CKKS refresh -----------------------------

def reference_refresh_precision(seed: int = 1234, log_n: int = 14, log_qp: int = 438):
    """The JAX package on the CPU, on chip_smoke.py's CKKS refresh at
    ckks_tpu_params(log_n, log_qp): three party keys, their collective
    public key (CRP seed b"mp-ckks-cpk"), the vector drawn from ``seed`` as
    chip_smoke.py draws it, encrypted at level 1, refreshed to the top with
    40-bit masks (CRP seed b"mp-ckks-refresh"), decrypted collectively (CKS
    to 0) and decoded: its get_precision_stats. chip_smoke.py's floor is
    this less one bit. A few minutes on the CPU at logN 14."""
    from lattigo_tpu import multiparty as jmp, presets as jpresets

    pj = jckks.Parameters(jpresets.ckks_tpu_params(log_n, log_qp))
    rng = np.random.default_rng(seed)
    slots = pj.max_slots
    v = rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots)
    keys = jax.random.split(jax.random.PRNGKey(seed), 8)
    kg = jrlwe.KeyGenerator(pj)
    sks = [kg.gen_secret_key(k) for k in keys[:3]]
    cpk_p = jmp.PublicKeyGenProtocol(pj)
    crp = cpk_p.sample_crp(b"mp-ckks-cpk")
    cpk = cpk_p.finalize(_aggregate(cpk_p, [cpk_p.gen_share(k, s, crp)
                                            for k, s in zip(keys[3:6], sks)]), crp)
    level, log_bound, ok = jsh.get_minimum_level_for_refresh(
        12, float(pj.default_scale_fraction), 3, pj.q_moduli)
    assert ok and level == 1 and log_bound == 40
    enc = jckks.Encoder(pj)
    ct = jrlwe.Encryptor(pj, cpk).encrypt(keys[6], enc.encode(v, level=level))
    proto = jsh.RefreshProtocol(pj, log_bound=log_bound)
    top = pj.max_level
    s2e_crp = proto.s2e.sample_crp(b"mp-ckks-refresh", top)
    e2s, s2e = [], []
    for i, s in enumerate(sks):
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed + 10 + i))
        mask, h = proto.e2s.gen_share(k1, s, ct)
        e2s.append(h)
        s2e.append(proto.s2e.gen_share(k2, s, mask, s2e_crp, top))
    pub = proto.e2s.finalize_public(ct, _aggregate(proto.e2s, e2s))
    out = proto.s2e.finalize(_aggregate(proto.s2e, s2e), s2e_crp,
                             extra_c0=proto.lift_public(pub, level, top),
                             scale=ct.scale, level=top)
    cks = jmp.KeySwitchProtocol(pj)
    agg = _aggregate(cks, [cks.gen_share(k, s, None, out)
                           for k, s in zip(jax.random.split(keys[7], 3), sks)])
    res = cks.key_switch(out, agg)
    got = enc.decode(jrlwe.Plaintext(value=res.value[..., 0, :, :], scale=res.scale))
    return jckks.get_precision_stats(v, got)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    print(reference_refresh_precision())
