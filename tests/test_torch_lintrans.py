"""Port parity for the hoisted-BSGS linear transformation and for the whole
CKKS slice.

``bsgs_split`` / ``bsgs_index`` are held equal on dense and strided
diagonal sets. At logN=12 with 5 Q and 2 P 28-bit limbs (the four-step
engine; the twin of ``ckks_tpu_params(14, 438)`` at a small N) the JAX
package, under one ``jax.jit``, encodes the diagonals (CKKS and BGV), makes
the keys and ciphertexts and runs ``evaluate`` and the slice's step
``rescale(evaluate(rescale(mul_relin(a, b))))`` on a batch; the port, on
the carried keys, ciphertexts and transformations, must give the same
residues (tolerance 0) and the same scale. Then the port's own keys run
the step and decode it against numpy's M·(a∘b).
"""

from fractions import Fraction

import numpy as np
import jax
import pytest
import torch

from lattigo_tpu import rlwe as jrlwe
from lattigo_tpu.circuits import lintrans as jlt
from lattigo_tpu.schemes import bgv as jbgv, ckks as jckks
from lattigo_tpu_torch import interop, rlwe as trlwe
from lattigo_tpu_torch.circuits import lintrans as tlt
from lattigo_tpu_torch.schemes import bgv as tbgv, ckks as tckks

LOG_N = 12
LIT = dict(log_n=LOG_N, log_q=(28,) * 5, log_p=(28, 28))
BATCH = 2
NDIAG = 16            # diagonals 0..15: n1 = 4, 3 baby and 3 giant rotations
LT_LEVEL = 3          # the level the slice's transformation runs at

DIAG_SETS = {
    "dense16": (list(range(16)), 2048),
    "strided256": ([256 * i for i in range(16)], 8192),
    "sparse": ([0, 1, 2, 5, 2047], 2048),
    "negative": ([-3, -1, 0, 1, 3], 1024),
    "mixed": ([0, 1, 2, 3, 64, 65, 66, 67, 512, 513], 4096),
    "single": ([7], 512),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here, and
    they crowd the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(DIAG_SETS))
@pytest.mark.parametrize("ratio", [0, 1, -1])
def test_bsgs_split_and_index(name, ratio):
    diags, slots = DIAG_SETS[name]
    n1 = tlt.bsgs_split(diags, slots, ratio)
    assert n1 == jlt.bsgs_split(diags, slots, ratio)
    assert tlt.bsgs_index(diags, slots, n1) == jlt.bsgs_index(diags, slots, n1)


def test_bsgs_split_of_the_slice():
    assert tlt.bsgs_split(list(range(NDIAG)), 8192) == 4


def _diagonals(rng, slots):
    lo, hi = -1 / NDIAG, 1 / NDIAG
    return {k: rng.uniform(lo, hi, slots) + 1j * rng.uniform(lo, hi, slots)
            for k in range(NDIAG)}


def _want(diags, v):
    want = np.zeros_like(v)
    for k, d in diags.items():
        want += d * np.roll(v, -k, axis=-1)
    return want


def _lt_arrays(lt, prefix):
    out = {f"{prefix}/{k}/q": x.q for k, x in lt.vec.items()}
    out.update({f"{prefix}/{k}/p": x.p for k, x in lt.vec.items()})
    return out


def _carried_lt(a, meta, prefix):
    return interop.linear_transformation_from_numpy(
        {k: (a[f"{prefix}/{k}/q"], a[f"{prefix}/{k}/p"]) for k in meta["keys"]},
        meta["n1"], meta["level_q"], meta["scale"], meta["slots"], "cpu")


@pytest.fixture(scope="module")
def ref():
    pj = jckks.Parameters(jckks.ParametersLiteral(**LIT, log_default_scale=28))
    pt = tckks.Parameters(tckks.ParametersLiteral(**LIT, log_default_scale=28),
                          device="cpu")
    slots = pj.max_slots
    rng = np.random.default_rng(41)
    va = rng.uniform(-1, 1, (BATCH, slots)) + 1j * rng.uniform(-1, 1, (BATCH, slots))
    vb = rng.uniform(-1, 1, (BATCH, slots)) + 1j * rng.uniform(-1, 1, (BATCH, slots))
    diags = _diagonals(rng, slots)
    lt_scale = pj.q_moduli[LT_LEVEL]
    kg = jrlwe.KeyGenerator(pj)
    encj = jckks.Encoder(pj)
    meta = {}

    def setup(key):
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        lt = jlt.encode_linear_transformation(
            pj, diags, jlt.ckks_diag_encoder(pj, encj, lt_scale),
            level_q=LT_LEVEL, scale=lt_scale, slots=slots)
        meta.update(keys=list(lt.vec), n1=lt.n1, level_q=lt.level_q,
                    scale=lt.scale, slots=lt.slots)
        els = lt.galois_elements(pj)
        sk = kg.gen_secret_key(k1)
        rlk = kg.gen_relinearization_key(k2, sk)
        gks = kg.gen_galois_keys(k3, els, sk, levels={g: LT_LEVEL for g in els})
        enc = jrlwe.Encryptor(pj, sk)
        ca = enc.encrypt(k4, encj.encode(va), batch=(BATCH,))
        cb = enc.encrypt(k5, encj.encode(vb), batch=(BATCH,))
        ev = jckks.Evaluator(pj, jrlwe.EvaluationKeySet(rlk, gks))
        lte = jlt.LinTransEvaluator(ev)
        mid = ev.rescale(ev.mul_relin(ca, cb))
        lin = lte.evaluate(mid, lt)
        out = ev.rescale(lin)
        one = lte.evaluate(jrlwe.Ciphertext(value=mid.value[0], scale=mid.scale), lt)
        meta.update(mid_scale=mid.scale, lin_scale=lin.scale, out_scale=out.scale,
                    gal_els=list(gks))
        dec = jrlwe.Decryptor(pj, sk).decrypt(out)
        keys = {f"gk/{g}/{part}": getattr(gk.gadget.value, part)
                for g, gk in gks.items() for part in ("q", "p")}
        return dict(_lt_arrays(lt, "lt"), **keys, sk_q=sk.value.q, sk_p=sk.value.p,
                    rlk_q=rlk.gadget.value.q, rlk_p=rlk.gadget.value.p,
                    ca=ca.value, cb=cb.value, mid=mid.value, lin=lin.value,
                    one=one.value, out=out.value,
                    dec_coeffs=pj.ring_q.intt(dec.value, dec.level))

    arrays = jax.jit(setup)(jax.random.PRNGKey(7))
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    return dict(pj=pj, pt=pt, va=va, vb=vb, diags=diags, lt_scale=lt_scale,
                arrays=arrays, meta=meta, encj=encj)


def _port(ref):
    a, meta, pt = ref["arrays"], ref["meta"], ref["pt"]
    evk = interop.evaluation_key_set_from_numpy(
        "cpu", rlk=(a["rlk_q"], a["rlk_p"]),
        galois_keys={g: (a[f"gk/{g}/q"], a[f"gk/{g}/p"]) for g in meta["gal_els"]})
    ev = tckks.Evaluator(pt, evk)
    return ev, tlt.LinTransEvaluator(ev), _carried_lt(a, meta, "lt")


def test_ckks_diagonal_encoding_bit_equal(ref):
    pt, a, meta = ref["pt"], ref["arrays"], ref["meta"]
    lt = tlt.encode_linear_transformation(
        pt, ref["diags"], tlt.ckks_diag_encoder(pt, tckks.Encoder(pt), ref["lt_scale"]),
        level_q=LT_LEVEL, scale=ref["lt_scale"], slots=pt.max_slots)
    assert (lt.n1, lt.level_q, lt.scale, lt.slots) == (
        meta["n1"], meta["level_q"], meta["scale"], meta["slots"]) and lt.n1 == 4
    assert sorted(lt.vec) == sorted(meta["keys"])
    assert lt.galois_elements(pt) == sorted(int(g) for g in meta["gal_els"])
    for k, x in lt.vec.items():
        np.testing.assert_array_equal(interop.to_numpy(x.q), a[f"lt/{k}/q"])
        np.testing.assert_array_equal(interop.to_numpy(x.p), a[f"lt/{k}/p"])
    # one diagonal at a time (no encode_batch) gives the same residues
    one = tlt.ckks_diag_encoder(pt, tckks.Encoder(pt), ref["lt_scale"])
    x = one(np.roll(ref["diags"][5], 4), LT_LEVEL)
    np.testing.assert_array_equal(interop.to_numpy(x.q), a["lt/5/q"])


@pytest.mark.parametrize("stage", ["mid", "lin", "out"])
def test_slice_bit_equal(ref, stage):
    """The whole step, rescale(evaluate(rescale(mul_relin(a, b)))), on a
    batch of two; each stage's residues and scale equal."""
    a, meta, pt = ref["arrays"], ref["meta"], ref["pt"]
    ev, lte, lt = _port(ref)
    s = pt.default_scale_fraction
    ca = interop.ciphertext_from_numpy(a["ca"], "cpu", scale=s)
    cb = interop.ciphertext_from_numpy(a["cb"], "cpu", scale=s)
    mid = ev.rescale(ev.mul_relin(ca, cb))
    got = {"mid": mid}
    if stage != "mid":
        got["lin"] = lte.evaluate(mid, lt)
        got["out"] = ev.rescale(got["lin"])
    assert got[stage].scale == meta[f"{stage}_scale"]
    assert isinstance(got[stage].scale, Fraction)
    np.testing.assert_array_equal(interop.to_numpy(got[stage].value), a[stage])


def test_evaluate_unbatched_bit_equal(ref):
    a, meta = ref["arrays"], ref["meta"]
    _, lte, lt = _port(ref)
    ct = interop.ciphertext_from_numpy(a["mid"][0], "cpu", scale=meta["mid_scale"])
    np.testing.assert_array_equal(interop.to_numpy(lte.evaluate(ct, lt).value), a["one"])


def test_slice_decodes(ref):
    """The JAX package's result decodes to M·(a∘b); the port decodes the
    same integers to the same floats."""
    a, meta, pt = ref["arrays"], ref["meta"], ref["pt"]
    sk = interop.secret_key_from_numpy(a["sk_q"], a["sk_p"], "cpu")
    ct = interop.ciphertext_from_numpy(a["out"], "cpu", scale=meta["out_scale"])
    have = tckks.Encoder(pt).decode(trlwe.Decryptor(pt, sk).decrypt(ct))
    for i in range(BATCH):
        want = ref["encj"].decode(jrlwe.Plaintext(
            value=a["dec_coeffs"][i], is_ntt=False, scale=meta["out_scale"]))
        np.testing.assert_allclose(have[i], want, rtol=2.0 ** -40, atol=0)
    tckks.verify_test_vectors(_want(ref["diags"], ref["va"] * ref["vb"]), have, 12.0)


def test_lifts_agree(ref):
    """lift_ints_qp (int64 on the device, Python integers on the host) and
    lift_f64_qp give the same residues; past 2^63 the host path's residues
    are the integers mod each prime."""
    pt = ref["pt"]
    rng = np.random.default_rng(43)
    small = rng.integers(-(1 << 40), 1 << 40, (2, pt.n))
    big = small.astype(object) * (1 << 40)
    a = tlt.lift_ints_qp(pt, small, LT_LEVEL)
    for b in (tlt.lift_ints_qp(pt, small.astype(object), LT_LEVEL),
              tlt.lift_f64_qp(pt, small.astype(np.float64), LT_LEVEL)):
        assert torch.equal(a.q, b.q) and torch.equal(a.p, b.p)
    c = tlt.lift_ints_qp(pt, big, LT_LEVEL)
    rq, rp = pt.ring_q, pt.ring_p
    for ring, x, moduli in ((rq, c.q, pt.q_moduli[: LT_LEVEL + 1]), (rp, c.p, pt.p_moduli)):
        got = interop.to_numpy(ring.intt(ring.imform(x, len(moduli) - 1), len(moduli) - 1))
        want = np.stack([np.mod(big, q) for q in moduli], axis=-2).astype(np.uint64)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="63-bit"):
        tlt.lift_f64_qp(pt, np.full((pt.n,), 2.0 ** 63), LT_LEVEL)


# -- BGV ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_bgv():
    lit = dict(LIT, t=65537)
    pj = jbgv.Parameters(jbgv.ParametersLiteral(**lit))
    pt = tbgv.Parameters(tbgv.ParametersLiteral(**lit), device="cpu")
    half = pj.n // 2
    rng = np.random.default_rng(42)
    diags = {k: rng.integers(0, pj.t, pj.n) for k in (0, 1, 3, 6)}
    m = rng.integers(0, pj.t, (BATCH, pj.n))
    kg = jrlwe.KeyGenerator(pj)
    encj = jbgv.Encoder(pj)
    meta = {}

    # the BGV diagonal encoder reads encode_ring_t's output back to the
    # host, which a trace cannot: its outputs for the pre-rotated diagonals
    # are computed first (one jit) and served to it from a table
    n1 = jlt.bsgs_split(sorted(diags), half)
    rots = [jlt.bgv_rotate_diag(d, k - k % n1) for k, d in diags.items()]
    coeffs_t = np.asarray(jax.jit(lambda: encj.encode_ring_t(np.stack(rots)))())

    class _Table:
        encode_ring_t = {r.tobytes(): c for r, c in zip(rots, coeffs_t)}.__getitem__

    table = _Table()

    def setup(key):
        k1, k2, k3 = jax.random.split(key, 3)
        lt = jlt.encode_linear_transformation(
            pj, diags, lambda v, lvl: jlt.bgv_diag_encoder(pj, table)(v.tobytes(), lvl),
            level_q=pj.max_level, scale=1, slots=half,
            rotate_diag=jlt.bgv_rotate_diag)
        meta.update(keys=list(lt.vec), n1=lt.n1, level_q=lt.level_q,
                    scale=lt.scale, slots=lt.slots)
        sk = kg.gen_secret_key(k1)
        gks = kg.gen_galois_keys(k2, lt.galois_elements(pj), sk)
        ct = jrlwe.Encryptor(pj, sk).encrypt(k3, encj.encode(m), batch=(BATCH,))
        ev = jbgv.Evaluator(pj, jrlwe.EvaluationKeySet(galois_keys=gks))
        out = jlt.LinTransEvaluator(ev).evaluate(ct, lt)
        meta.update(out_scale=out.scale, gal_els=list(gks))
        keys = {f"gk/{g}/{part}": getattr(gk.gadget.value, part)
                for g, gk in gks.items() for part in ("q", "p")}
        return dict(_lt_arrays(lt, "lt"), **keys, sk_q=sk.value.q, sk_p=sk.value.p,
                    ct=ct.value, out=out.value)

    arrays = jax.jit(setup)(jax.random.PRNGKey(8))
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    return dict(pt=pt, diags=diags, m=m, half=half, arrays=arrays, meta=meta)


def test_bgv_diagonal_encoding_bit_equal(ref_bgv):
    pt, a, meta = ref_bgv["pt"], ref_bgv["arrays"], ref_bgv["meta"]
    lt = tlt.encode_linear_transformation(
        pt, ref_bgv["diags"], tlt.bgv_diag_encoder(pt, tbgv.Encoder(pt)),
        level_q=pt.max_level, scale=1, slots=ref_bgv["half"],
        rotate_diag=tlt.bgv_rotate_diag)
    assert (lt.n1, lt.level_q, lt.scale, lt.slots) == (
        meta["n1"], meta["level_q"], meta["scale"], meta["slots"])
    for k, x in lt.vec.items():
        np.testing.assert_array_equal(interop.to_numpy(x.q), a[f"lt/{k}/q"])
        np.testing.assert_array_equal(interop.to_numpy(x.p), a[f"lt/{k}/p"])


def test_bgv_evaluate_bit_equal_and_decodes(ref_bgv):
    pt, a, meta = ref_bgv["pt"], ref_bgv["arrays"], ref_bgv["meta"]
    evk = interop.evaluation_key_set_from_numpy("cpu", galois_keys={
        g: (a[f"gk/{g}/q"], a[f"gk/{g}/p"]) for g in meta["gal_els"]})
    ev = tbgv.Evaluator(pt, evk)
    lt = _carried_lt(a, meta, "lt")
    ct = interop.ciphertext_from_numpy(a["ct"], "cpu", scale=1)
    out = tlt.LinTransEvaluator(ev).evaluate(ct, lt)
    assert out.scale == meta["out_scale"]
    np.testing.assert_array_equal(interop.to_numpy(out.value), a["out"])
    half, m = ref_bgv["half"], ref_bgv["m"]

    def rot(v, k):
        return np.concatenate([np.roll(v[..., :half], -k, axis=-1),
                               np.roll(v[..., half:], -k, axis=-1)], axis=-1)

    want = np.zeros(m.shape, dtype=object)
    for k, d in ref_bgv["diags"].items():
        want = (want + d.astype(object) * rot(m, k).astype(object)) % pt.t
    sk = interop.secret_key_from_numpy(a["sk_q"], a["sk_p"], "cpu")
    got = tbgv.Encoder(pt).decode(trlwe.Decryptor(pt, sk).decrypt(out))
    np.testing.assert_array_equal(got, want.astype(np.int64))


# -- the port's own keys ----------------------------------------------------------

def test_own_keys_slice(ref):
    """The port alone: its keys (Galois keys level-scoped to the
    transformation's level), its encoders, the step on a batch, decoded
    against numpy at the floor of the JAX result above less a bit."""
    pt = ref["pt"]
    gen = torch.Generator().manual_seed(12)
    kg = trlwe.KeyGenerator(pt)
    sk = kg.gen_secret_key(gen)
    enc = tckks.Encoder(pt)
    lt = tlt.encode_linear_transformation(
        pt, ref["diags"], tlt.ckks_diag_encoder(pt, enc, ref["lt_scale"]),
        level_q=LT_LEVEL, scale=ref["lt_scale"], slots=pt.max_slots)
    els = lt.galois_elements(pt)
    gks = kg.gen_galois_keys(gen, els, sk, levels={g: LT_LEVEL for g in els})
    ev = tckks.Evaluator(pt, trlwe.EvaluationKeySet(
        kg.gen_relinearization_key(gen, sk), gks))
    encryptor = trlwe.Encryptor(pt, sk)
    ca = encryptor.encrypt(gen, enc.encode(ref["va"]), batch=(BATCH,))
    cb = encryptor.encrypt(gen, enc.encode(ref["vb"]), batch=(BATCH,))
    out = ev.rescale(tlt.LinTransEvaluator(ev).evaluate(
        ev.rescale(ev.mul_relin(ca, cb)), lt))
    assert out.level == LT_LEVEL - 1 and out.scale == ref["meta"]["out_scale"]
    got = enc.decode(trlwe.Decryptor(pt, sk).decrypt(out))
    assert got.shape == (BATCH, pt.max_slots)
    tckks.verify_test_vectors(_want(ref["diags"], ref["va"] * ref["vb"]), got, 12.0)


def reference_precision(seed: int = 1234, batch: int = 4, log_n: int = 14,
                        log_qp: int = 438):
    """The JAX package on the CPU, on chip_smoke.py's CKKS step at
    ckks_tpu_params(log_n, log_qp) with the same inputs (drawn from
    ``seed`` in the same order): the get_precision_stats of the step and of
    rescale(mul_relin) alone. chip_smoke.py's floors are the step's less
    one bit. About ten minutes on the CPU at (14, 438)."""
    from lattigo_tpu import presets as jpresets

    pj = jckks.Parameters(jpresets.ckks_tpu_params(log_n, log_qp))
    slots = pj.max_slots
    rng = np.random.default_rng(seed)

    def uniform(bound, shape):
        return rng.uniform(-bound, bound, shape) + 1j * rng.uniform(-bound, bound, shape)

    a, b = uniform(1.0, (batch, slots)), uniform(1.0, (batch, slots))
    diags = {k: uniform(1.0 / NDIAG, slots) for k in range(NDIAG)}
    level = pj.max_level - 1
    enc = jckks.Encoder(pj)
    lt = jlt.encode_linear_transformation(
        pj, diags, jlt.ckks_diag_encoder(pj, enc, pj.q_moduli[level]),
        level_q=level, scale=pj.q_moduli[level], slots=slots)
    els = lt.galois_elements(pj)
    kg = jrlwe.KeyGenerator(pj)
    k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(seed), 5)
    sk = kg.gen_secret_key(k1)
    ev = jckks.Evaluator(pj, jrlwe.EvaluationKeySet(
        kg.gen_relinearization_key(k2, sk),
        kg.gen_galois_keys(k3, els, sk, levels={g: level for g in els})))
    encryptor, decryptor = jrlwe.Encryptor(pj, sk), jrlwe.Decryptor(pj, sk)
    ca = encryptor.encrypt(k4, enc.encode(a), batch=(batch,))
    cb = encryptor.encrypt(k5, enc.encode(b), batch=(batch,))

    def decode(ct):
        pt = decryptor.decrypt(ct)
        v = np.asarray(pt.value)
        return np.stack([enc.decode(jrlwe.Plaintext(value=v[i], scale=pt.scale))
                         for i in range(batch)])

    mid = ev.rescale(ev.mul_relin(ca, cb))
    out = ev.rescale(jlt.LinTransEvaluator(ev).evaluate(mid, lt))
    return (jckks.get_precision_stats(_want(diags, a * b), decode(out)),
            jckks.get_precision_stats(a * b, decode(mid)))


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    # python tests/test_torch_lintrans.py [logN logQP]
    shape = dict(log_n=int(sys.argv[1]), log_qp=int(sys.argv[2])) if len(sys.argv) > 2 else {}
    step, mul = reference_precision(**shape)
    print(f"step {step}\nrescale(mul_relin) {mul}")
