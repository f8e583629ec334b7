"""Port parity for parameters as JSON, noise telemetry, serialization, the
BGV presets, the rest of the public ring API and the missing-key errors.

- ``ParametersLiteral.to_json`` gives the JAX package's text for an RLWE, a
  BGV and a CKKS literal, and the port reads the JAX package's text back to
  an equal literal of its own class (``interop.parameters_literal_from_json``);
- ``noise_fresh_sk`` / ``noise_fresh_pk``, ``log_q_big``, ``max_level_p``,
  equality and hashing equal the JAX package's;
- ``utils.serialization`` round-trips every kind of object bit for bit, and
  a restored ciphertext decrypts; a blob that names anything but a dataclass
  of the port (a function reached through a dotted name, a class outside the
  package, a plain class of the package) is refused with ``ValueError`` and
  runs nothing;
- ``log2_noise_std`` of one ciphertext (the port's, carried across) equal in
  both packages to 1e-9;
- the BGV and BGV-SI presets draw the JAX package's primes;
- ``mul_mont_lazy``, ``mul_coeffs_barrett``, ``reduce``, ``mul_by_monomial``,
  ``div_by_last_modulus_many`` and the QP ``add_lazy`` / ``mul_mont_lazy`` /
  ``reduce`` / ``reduce_lazy`` bit-equal to the JAX package's (under one
  ``jax.jit``) on 28-bit and 50-bit primes, lazy outputs compared mod q;
- a BGV and a CKKS ``mul_relin`` with no key and a rotation whose key is
  missing raise the same types in both packages, each a ``KeyError``.
"""

from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lattigo_tpu import presets as jpresets, rlwe as jrlwe
from lattigo_tpu.ring import scaling as jscaling
from lattigo_tpu.ring.ring import Ring as JRing
from lattigo_tpu.ring.ringqp import QPPoly as JQPPoly, RingQP as JRingQP
from lattigo_tpu.rlwe import elements as jel, encryption as jdecryptor, keys as jkeys
from lattigo_tpu.rlwe.params import gen_moduli as j_gen_moduli
from lattigo_tpu.schemes import bgv as jbgv, ckks as jckks
from lattigo_tpu.utils import noise as jnoise
from lattigo_tpu_torch import interop, presets as tpresets, rlwe
from lattigo_tpu_torch.multiparty.threshold import ShamirPolynomial
from lattigo_tpu_torch.ring import scaling as tscaling
from lattigo_tpu_torch.ring.ring import Ring as TRing
from lattigo_tpu_torch.ring.ringqp import QPPoly, RingQP
from lattigo_tpu_torch.rlwe.params import gen_moduli as t_gen_moduli
from lattigo_tpu_torch.schemes import bgv, ckks
from lattigo_tpu_torch.utils import noise as tnoise, serialization as ser
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


# -- parameters as JSON ------------------------------------------------------------

def literals(pkg_rlwe, pkg_bgv, pkg_ckks, pkg_presets, which):
    """One literal of each kind, built from a package's own classes."""
    if which == "rlwe":
        return pkg_rlwe.ParametersLiteral(
            log_n=11, log_q=(45, 38), log_p=(50,), xe=pkg_rlwe.DiscreteGaussian(3.2, 19.2),
            xs=pkg_rlwe.Ternary(p=2 / 3))
    if which == "rlwe-q":
        return pkg_rlwe.ParametersLiteral(
            log_n=10, q=(1152921504606584833,), xs=pkg_rlwe.Ternary(hamming_weight=64),
            xe=pkg_rlwe.DiscreteGaussian(1.0, 6.0), ntt_flag=False, default_scale=2.5)
    if which == "bgv":
        return pkg_presets.BGV_SI_PARAMS_N13_QP218
    if which == "ckks":
        return pkg_presets.CKKS_REAL_PARAMS_N12_QP109
    return pkg_ckks.ParametersLiteral(log_n=10, log_q=(40, 30), log_default_scale=30,
                                      xs=pkg_rlwe.Uniform())


KINDS = ["rlwe", "rlwe-q", "bgv", "ckks", "ckks-uniform"]


@pytest.mark.parametrize("which", KINDS)
def test_literal_json_across_packages(which):
    jlit = literals(jrlwe, jbgv, jckks, jpresets, which)
    tlit = literals(rlwe, bgv, ckks, tpresets, which)
    text = tlit.to_json()
    assert text == jlit.to_json()
    back = interop.parameters_literal_from_json(jlit.to_json())
    assert type(back) is type(tlit) and back == tlit
    assert type(tlit).from_json(text) == tlit
    if which.startswith("rlwe"):       # the JAX package reads the port's text
        assert jrlwe.ParametersLiteral.from_json(text) == jlit


PARAM_CASES = {
    "single-P": dict(log_n=9, log_q=(45, 38), log_p=(50,)),
    "two-P": dict(log_n=9, log_q=(30, 30, 30), log_p=(31, 31)),
    "no-P": dict(log_n=9, log_q=(45, 38)),
    "hamming": dict(log_n=9, log_q=(45,), log_p=(50,), xs="h", xe="g"),
}


def case_lit(pkg, name):
    kw = dict(PARAM_CASES[name])
    if kw.pop("xs", None):
        kw.update(xs=pkg.Ternary(hamming_weight=32), xe=pkg.DiscreteGaussian(2.0, 12.0))
        kw.pop("xe")
    return pkg.ParametersLiteral(**kw)


@pytest.mark.parametrize("name", list(PARAM_CASES))
def test_parameter_properties_equal(name):
    jp = jrlwe.Parameters(case_lit(jrlwe, name))
    tp = rlwe.Parameters(case_lit(rlwe, name), device="cpu")
    assert tp.noise_fresh_sk() == jp.noise_fresh_sk()
    assert tp.noise_fresh_pk() == jp.noise_fresh_pk()
    assert tp.max_level_p == jp.max_level_p
    for level in range(tp.max_level + 1):
        assert tp.log_q_big(level) == jp.log_q_big(level)
    assert tp.log_q_big() == jp.log_q_big()
    same = rlwe.Parameters(case_lit(rlwe, name), device="cpu")
    assert same == tp and hash(same) == hash(tp)
    assert hash(tp) == hash(jp)          # the same tuple is hashed
    other = rlwe.Parameters(rlwe.ParametersLiteral(log_n=9, log_q=(45, 38, 38)), device="cpu")
    assert other != tp and tp != "params"


# -- serialization -------------------------------------------------------------------

@pytest.fixture(scope="module")
def bgv_ctx():
    params = bgv.Parameters(bgv.ParametersLiteral(
        log_n=9, log_q=(45, 38), log_p=(50,), t=65537), device="cpu")
    gen = torch.Generator().manual_seed(1)
    kg = rlwe.KeyGenerator(params)
    sk = kg.gen_secret_key(gen)
    enc = bgv.Encoder(params)
    m = np.arange(params.n, dtype=np.int64) % params.t
    ct = rlwe.Encryptor(params, sk).encrypt(gen, enc.encode(m))
    return params, gen, kg, sk, enc, m, ct


def leaves(x):
    """Every tensor / array of an object, in field order, and its scalars."""
    if isinstance(x, torch.Tensor):
        return [("t", x.dtype, x.device.type, x.numpy().tobytes())]
    if isinstance(x, np.ndarray):
        return [("a", x.dtype, x.tobytes())]
    if isinstance(x, dict):
        return [("k", k) for k in x] + [l for v in x.values() for l in leaves(v)]
    if isinstance(x, (list, tuple)):
        return [type(x).__name__] + [l for v in x for l in leaves(v)]
    if hasattr(x, "__dict__"):
        return [type(x).__name__] + [l for k, v in vars(x).items()
                                     for l in [k] + leaves(v)]
    return [x]


def test_serialization_roundtrip(bgv_ctx, tmp_path):
    params, gen, kg, sk, enc, m, ct = bgv_ctx
    rlk = kg.gen_relinearization_key(gen, sk)
    g = params.galois_element(1)
    gadget = kg.gadget_encrypt(gen, sk.value.q, sk, seed=b"seed")
    objs = {
        "sk": sk, "pk": kg.gen_public_key(gen, sk), "ct": ct, "rlk": rlk,
        "rlk_base2": kg.gen_relinearization_key(gen, sk, base2=14),
        "keys": rlwe.EvaluationKeySet(rlk, kg.gen_galois_keys(gen, [g], sk)),
        "compressed": rlwe.compress_gadget(gadget, b"seed"),
        "ckks_ct": ct.replace(scale=Fraction(2**56, 1125899906826241)),
        "shamir": ShamirPolynomial([sk.value, sk.value]),
        "share": [sk.value.q, (sk.value.p, np.arange(3, dtype=np.uint64))],
        "literal": params.literal,
    }
    for name, obj in objs.items():
        back = ser.loads(ser.dumps(obj), device="cpu")
        assert type(back) is type(obj), name
        assert leaves(back) == leaves(obj), name
    path = tmp_path / "ct.npz"
    ser.save(ct, str(path))
    got = enc.decode(rlwe.Decryptor(params, sk).decrypt(ser.load(str(path), device="cpu")))
    np.testing.assert_array_equal(got, m)
    with pytest.raises(TypeError):
        ser.dumps(params)
    with pytest.raises(TypeError):
        ser.dumps(object())


def forged_blob(node) -> bytes:
    """A container in :mod:`utils.serialization`'s layout with ``node`` as its
    structure and no arrays, as a hostile peer could send it."""
    import io
    import json
    buf = io.BytesIO()
    np.savez(buf, structure=np.frombuffer(json.dumps(node).encode(), dtype=np.uint8))
    return buf.getvalue()


@pytest.mark.parametrize("name", [
    "lattigo_tpu_torch.build:subprocess.run",       # a dotted walk to a function
    "subprocess:run",                              # outside the package
    "pathlib:Path",                                # a class outside the package
    "lattigo_tpu_torch.build:subprocess",          # a module, not a class
    "lattigo_tpu_torch.rlwe.params:Parameters",    # a plain class of the package
    "lattigo_tpu_torch.rlwe.keys:QPPoly",          # imported, not defined there
    "lattigo_tpu_torch.rlwe.elements:Ciphertext.__init__",
])
@pytest.mark.parametrize("body", ["fields", "state"])
def test_serialization_refuses_forged_class(name, body, tmp_path):
    marker = tmp_path / "ran"
    argv = ["sh", "-c", f"touch {marker}"]
    node = {"class": name, body: {"args": {"list": argv}}}
    with pytest.raises(ValueError):
        ser.loads(forged_blob(node), device="cpu")
    with pytest.raises(ValueError):               # nested inside a list
        ser.loads(forged_blob({"list": [1, node]}), device="cpu")
    assert not marker.exists()


def test_serialization_refuses_unknown_fields():
    node = {"class": "lattigo_tpu_torch.rlwe.keys:SecretKey",
            "fields": {"value": None, "extra": 1}}
    with pytest.raises(ValueError):
        ser.loads(forged_blob(node), device="cpu")
    ok = {"class": "lattigo_tpu_torch.rlwe.keys:SecretKey", "fields": {"value": 7}}
    assert ser.loads(forged_blob(ok), device="cpu") == rlwe.SecretKey(7)


# -- noise telemetry ---------------------------------------------------------------

def test_log2_noise_std_equal(bgv_ctx):
    params, gen, kg, sk, enc, m, ct = bgv_ctx
    zero = rlwe.Encryptor(params, sk).encrypt_zero(gen)
    got = tnoise.log2_noise_std(params, sk, zero)
    assert 0.5 < got < 3.5
    jp = jbgv.Parameters(jbgv.ParametersLiteral(
        log_n=9, q=tuple(params.q_moduli), p=tuple(params.p_moduli), t=params.t))
    jsk = jkeys.SecretKey(JQPPoly(interop.to_numpy(sk.value.q), interop.to_numpy(sk.value.p)))
    jct = jel.Ciphertext(jnp.asarray(interop.to_numpy(zero.value)), is_ntt=True)
    # the JAX package's decryption and INTT as one jax.jit each (eager, they
    # compile op by op)
    eager_decrypt, eager_intt = jdecryptor.Decryptor.decrypt, JRing.intt
    jdecryptor.Decryptor.decrypt = lambda self, c: jax.jit(eager_decrypt, static_argnums=0)(self, c)
    jp.ring_q.intt = jax.jit(lambda v, level: eager_intt(jp.ring_q, v, level), static_argnums=1)
    try:
        want = jnoise.log2_noise_std(jp, jsk, jct)
    finally:
        jdecryptor.Decryptor.decrypt = eager_decrypt
        del jp.ring_q.intt
    assert abs(got - want) <= 1e-9
    # with the plaintext subtracted: the same noise as the zero encryption's
    pt = enc.encode(m)
    pt_coeffs = params.ring_q.intt(pt.value)
    assert abs(tnoise.log2_noise_std(params, sk, ct, pt_coeffs)
               - tnoise.log2_std(tnoise.ciphertext_noise(params, sk, ct, pt_coeffs))) == 0
    assert tnoise.log2_std([5, 5, 5]) == float("-inf")


# -- presets -----------------------------------------------------------------------

@pytest.mark.parametrize("k", range(4))
@pytest.mark.parametrize("group", ["BGV_PARAMS", "BGV_SI_PARAMS"])
def test_bgv_presets_moduli(group, k):
    tlit, jlit = getattr(tpresets, group)[k], getattr(jpresets, group)[k]
    assert tlit.to_json() == jlit.to_json()
    nth = 2 << tlit.log_n
    assert (t_gen_moduli(tlit.log_n, nth, tlit.log_q, tlit.log_p)
            == j_gen_moduli(jlit.log_n, nth, jlit.log_q, jlit.log_p))


# -- ring operations ---------------------------------------------------------------

def _primes(bits: int, n: int, count: int) -> list[int]:
    gen = NTTFriendlyPrimesGenerator(bits, 2 * n)
    return [gen.next_alternating_prime() for _ in range(count)]


@pytest.mark.parametrize("bits", [28, 50])
def test_ring_operations_bit_equal(bits):
    n = 64
    q_mod, p_mod = _primes(bits, n, 3), _primes(bits + 1, n, 2)
    tq, tp = TRing(n, q_mod, device="cpu"), TRing(n, p_mod, device="cpu")
    jq, jp_ = JRing(n, q_mod), JRing(n, p_mod)
    trqp, jrqp = RingQP(tq, tp), JRingQP(jq, jp_)
    rng = np.random.default_rng(bits)
    qs = np.array(q_mod, dtype=object)[:, None]
    ps = np.array(p_mod, dtype=object)[:, None]

    def canon(mods):
        return (rng.integers(0, 1 << 62, (3, len(mods), n)).astype(object)
                % np.array(mods, dtype=object)[:, None]).astype(np.uint64)

    a, b = canon(q_mod), canon(q_mod)
    ap, bp = canon(p_mod), canon(p_mod)
    wide = rng.integers(0, 1 << 63, (3, 3, n), dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    widep = rng.integers(0, 1 << 63, (3, 2, n), dtype=np.uint64)
    shifts = [0, 1, 5, n - 1, n, n + 3, 2 * n, -1, -n - 2, 7 * n + 9]

    def ops(R, RQP, QP, scaling, a, b, ap, bp, wide, widep):
        out = {
            "mul_mont_lazy": R.mul_mont_lazy(a, b),
            "mul_mont_lazy_l1": R.mul_mont_lazy(a[:, :2], b[:, :2], 1),
            "mul_coeffs_barrett": R.mul_coeffs_barrett(a, b),
            "reduce": R.reduce(wide),
            "reduce_l0": R.reduce(wide[:, :1], 0),
            "div_many_coeff": scaling.div_by_last_modulus_many(R, a, 2),
            "div_many_ntt": scaling.div_by_last_modulus_many(R, a, 1, ntt_domain=True),
            "div_many_floor": scaling.div_by_last_modulus_many(R, a, 2, round_div=False),
        }
        for k in shifts:
            out[f"monomial_{k}"] = R.mul_by_monomial(a, k)
        out["monomial_l1"] = R.mul_by_monomial(a[:, :2], 3, 1)
        x, y, z = QP(a, ap), QP(b, bp), QP(wide, widep)
        for name, v in (("qp_add_lazy", RQP.add_lazy(x, y)),
                        ("qp_mul_mont_lazy", RQP.mul_mont_lazy(x, y)),
                        ("qp_reduce", RQP.reduce(z)),
                        ("qp_reduce_lazy", RQP.reduce_lazy(z)),
                        ("qp_reduce_lazy_l1", RQP.reduce_lazy(QP(wide[:, :2], widep), 1))):
            out[name + "_q"], out[name + "_p"] = v.q, v.p
        return out

    t_args = [interop.to_torch(v, "cpu") for v in (a, b, ap, bp, wide, widep)]
    got = ops(tq, trqp, QPPoly, tscaling, *t_args)
    fn = jax.jit(lambda *args: ops(jq, jrqp, JQPPoly, jscaling, *args))
    want = fn.lower(a, b, ap, bp, wide, widep).compile(FAST_COMPILE)(
        *(jnp.asarray(v) for v in (a, b, ap, bp, wide, widep)))
    lazy = ("mul_mont_lazy", "qp_mul_mont_lazy", "qp_reduce_lazy", "qp_add_lazy")
    for name, w in want.items():
        g = interop.to_numpy(got[name])
        w = np.asarray(w)
        assert g.shape == w.shape, name
        if name.startswith(lazy):
            mods = ps if name.endswith("_p") else qs[: g.shape[-2]]
            np.testing.assert_array_equal(g.astype(object) % mods, w.astype(object) % mods,
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# -- missing keys --------------------------------------------------------------------

def test_missing_key_errors_match():
    """BGV and CKKS mul_relin without a key and a rotation whose key is
    missing raise the same types in both packages (the JAX side only
    traced, with jax.eval_shape), each a MissingKeyError and a KeyError."""
    blit = dict(log_n=9, log_q=(45, 38), log_p=(50,), t=65537)
    clit = dict(log_n=9, log_q=(45, 38), log_p=(50,), log_default_scale=38)
    cases = []
    for scheme_t, scheme_j, kw in ((bgv, jbgv, blit), (ckks, jckks, clit)):
        tp = scheme_t.Parameters(scheme_t.ParametersLiteral(**kw), device="cpu")
        jp = scheme_j.Parameters(scheme_j.ParametersLiteral(**kw))
        tev, jev = scheme_t.Evaluator(tp), scheme_j.Evaluator(jp)
        shape = (2, 2, tp.n)
        scale = 1 if scheme_t is bgv else Fraction(2**38)
        tct = rlwe.Ciphertext(torch.zeros(shape, dtype=torch.int64), scale=scale)

        def jct(v, scale=scale):
            return jel.Ciphertext(v, scale=scale)

        rot = "rotate_columns" if scheme_t is bgv else "rotate"
        cases.append((lambda tev=tev, tct=tct: tev.mul_relin(tct, tct),
                      lambda v, jev=jev, jct=jct: jev.mul_relin(jct(v), jct(v)).value))
        cases.append((lambda tev=tev, tct=tct, rot=rot: getattr(tev, rot)(tct, 1),
                      lambda v, jev=jev, jct=jct, rot=rot: getattr(jev, rot)(jct(v), 1).value))
    spec = jax.ShapeDtypeStruct((2, 2, 512), jnp.uint64)
    for run_t, run_j in cases:
        with pytest.raises(rlwe.MissingKeyError) as got:
            run_t()
        with pytest.raises(jrlwe.MissingKeyError) as want:
            jax.eval_shape(run_j, spec)
        assert type(got.value).__name__ == type(want.value).__name__
        assert isinstance(got.value, KeyError)
        assert str(got.value).split(" — ")[0] == str(want.value).split(" — ")[0]
    for cls_t, cls_j in ((rlwe.MissingGaloisKeyError, jrlwe.MissingGaloisKeyError),):
        e_t, e_j = cls_t(25, rotation=3), cls_j(25, rotation=3)
        assert (e_t.gal_el, e_t.rotation) == (e_j.gal_el, e_j.rotation) == (25, 3)
        assert str(e_t).split(" — ")[0] == str(e_j).split(" — ")[0]
        assert "slot rotation by 3" in str(e_t)
    assert issubclass(rlwe.MissingRelinearizationKeyError, KeyError)
