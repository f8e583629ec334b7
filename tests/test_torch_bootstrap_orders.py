"""Port parity for the slim circuit order and META-BTS.

At the parameters of the JAX package's slow-tier ``tests/test_bootstrap.py``
(logN 8, 18 limbs, K = 16, degree 30, 4 double angles, message ratio
2^10), the JAX package makes the keys and the input ciphertexts and runs
its own ``bootstrap`` in the slim order (DECODE_THEN_MODUP: S2C → ScaleDown
→ ModUp → C2S → EvalMod → recombine) and its own ``bootstrap_meta`` (two
iterations) in the standard order. The port, on the carried keys and
ciphertexts, must give the same residues (tolerance 0), the same exact
``Fraction`` scales and the same levels: at every slim stage, for both
outputs, and in the level layout of both orders.

The JAX side runs its evaluator's own control flow (the slim branch, the
q0 relabel, the META-BTS loop), with each stage method compiled once per
input metadata. Eager JAX would compile op by op and take many minutes; a
compiled stage is the same function (the stages are integer-exact, so the
XLA optimisation level, turned down here to save compile time, cannot
change a residue). The two orders share their C2S matrices and EvalMod
(checked equal), so those two stages are compiled once for both.
"""

from fractions import Fraction

import numpy as np
import jax
import pytest
import torch

from lattigo_tpu import rlwe as jrlwe
from lattigo_tpu.circuits import bootstrapping as jbts, mod1 as jmod1
from lattigo_tpu.rlwe.elements import Ciphertext as JCiphertext
from lattigo_tpu.schemes import ckks as jckks
from lattigo_tpu_torch import interop, rlwe as trlwe
from lattigo_tpu_torch.circuits import bootstrapping as tbts, mod1 as tmod1
from lattigo_tpu_torch.schemes import ckks as tckks

LITERAL = dict(log_n=8, log_q=(55,) + (45,) * 3 + (55,) * 14, log_p=(60, 60),
               log_default_scale=45)
# the JAX package's slow-tier precision floor at these parameters
MIN_BITS = 8.0
META_ITERATIONS, META_LOG_PREC = 2, 6
SLIM_STAGES = ["s2c", "pre", "c2s re", "c2s im", "mod1 re", "mod1 im", "out"]
# XLA's CPU backend at its lowest optimisation level: a fraction of the
# default compile time for these integer-only programs
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's ops here act on small tensors, where torch's intra-op
    threads only add overhead: one thread runs this file faster and leaves
    the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bts_params(bts, mod1, order):
    return bts.BootstrappingParameters(
        c2s_levels=[4, 3], s2c_levels=[4, 3],
        mod1=mod1.Mod1Parameters(k=16, degree=30, double_angle=4,
                                 log_message_ratio=10),
        residual_levels=1, circuit_order=order)


def _compiled(fn, log=None, name=None):
    """fn, compiled once per distinct ciphertext metadata (and per value of
    its other, static, arguments); called while another stage is being
    traced, it runs fn itself. Each eager call's output is appended to
    ``log`` as (name, output)."""
    jits = {}

    def call(*args, **kw):
        cts = [a for a in args if isinstance(a, JCiphertext)]
        if any(isinstance(c.value, jax.core.Tracer) for c in cts):
            return fn(*args, **kw)
        static = tuple(None if isinstance(a, JCiphertext) else a for a in args)
        key = (static, tuple(sorted(kw.items())))
        if key not in jits:
            def raw(*dyn):
                it = iter(dyn)
                return fn(*[next(it) if s is None else s for s in static], **kw)
            jits[key] = jax.jit(raw, compiler_options=_FAST_COMPILE)
        out = jits[key](*cts)
        if log is not None:
            log.append((name, out))
        return out
    return call


def _gadget_np(gadget):
    return np.asarray(gadget.value.q), np.asarray(gadget.value.p)


def _ct_np(ct):
    return np.asarray(ct.value), ct.level, Fraction(ct.scale)


def _layout(b, ct):
    return dict(
        level_c2s_top=b.level_c2s_top, level_mod1_top=b.level_mod1_top,
        level_s2c_top=b.level_s2c_top,
        minimum_input_level=b.minimum_input_level, output_level=b.output_level,
        modup_scalar=b._modup_scalar, mod1_scale=b._mod1_scale,
        galois_elements=b.galois_elements(),
        galois_element_levels=b.galois_element_levels(),
        scale_down_label=b.scale_down_label(ct.level, ct.scale))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's keys, inputs, slim stages and both outputs, as
    numpy arrays and exact metadata."""
    params = jckks.Parameters(jckks.ParametersLiteral(**LITERAL))
    kgen = jrlwe.KeyGenerator(params)
    k_sk, k_rlk, k_gk, k_slim, k_meta = jax.random.split(jax.random.PRNGKey(0), 5)
    sk = kgen.gen_secret_key(k_sk)
    rlk = kgen.gen_relinearization_key(k_rlk, sk)
    enc = jckks.Encoder(params)
    ev0 = jckks.Evaluator(params, jrlwe.EvaluationKeySet(relinearization_key=rlk))
    std, slim = (jbts.BootstrappingEvaluator(params, ev0, enc, _bts_params(
        jbts, jmod1, order)) for order in (jbts.MODUP_THEN_ENCODE,
                                            jbts.DECODE_THEN_MODUP))
    els = sorted(set(std.galois_elements()) | set(slim.galois_elements()))
    gks = kgen.gen_galois_keys(k_gk, els, sk)
    ev = jckks.Evaluator(params, jrlwe.EvaluationKeySet(
        relinearization_key=rlk, galois_keys=gks))
    for name in ("add", "sub", "mul_by_i", "mul_scalar_int"):
        setattr(ev, name, _compiled(getattr(ev, name)))
    std.with_evaluator(ev)
    slim.with_evaluator(ev)

    # the two orders share C2S (same level, matrices and scaling) and
    # EvalMod: compile them once
    for a, b in zip(std.dft.c2s_mats, slim.dft.c2s_mats):
        assert sorted(a.vec) == sorted(b.vec)
        assert (a.n1, a.level_q, a.scale) == (b.n1, b.level_q, b.scale)
        for k in a.vec:
            np.testing.assert_array_equal(np.asarray(a.vec[k].q), np.asarray(b.vec[k].q))
            np.testing.assert_array_equal(np.asarray(a.vec[k].p), np.asarray(b.vec[k].p))
    assert std._mod1_scale == slim._mod1_scale
    assert vars(std.btp.mod1) == vars(slim.btp.mod1)
    log = []
    c2s = _compiled(std.coeffs_to_slots, log, "c2s")
    mod1 = _compiled(std.mod1.evaluate, log, "mod1")
    for b in (std, slim):
        b.coeffs_to_slots = c2s
        b.mod1.evaluate = mod1
        for name in ("slots_to_coeffs", "scale_down"):
            setattr(b, name, _compiled(getattr(b, name), log, name))
        b.mod_up = _compiled(b.mod_up, log, "pre")
        b.dft.slots_to_coeffs = _compiled(b.dft.slots_to_coeffs)

    def fresh(seed, key, level):
        rng = np.random.default_rng(seed)
        v = (rng.uniform(-1, 1, params.max_slots)
             + 1j * rng.uniform(-1, 1, params.max_slots))
        return v, jrlwe.Encryptor(params, sk).encrypt(key, enc.encode(v)).at_level(level)

    v_slim, ct_slim = fresh(1, k_slim, slim.minimum_input_level)
    v_meta, ct_meta = fresh(2, k_meta, std.minimum_input_level)
    layouts = {"std": _layout(std, ct_meta), "slim": _layout(slim, ct_slim)}
    out_slim = slim.bootstrap(ct_slim)
    got = dict(log)
    stages = {"s2c": got["slots_to_coeffs"], "pre": got["pre"],
              "c2s re": got["c2s"][0], "c2s im": got["c2s"][1],
              "out": out_slim}
    stages["mod1 re"], stages["mod1 im"] = (o for n, o in log if n == "mod1")
    out_meta = std.bootstrap_meta(ct_meta, iterations=META_ITERATIONS,
                                  log_prec=META_LOG_PREC)
    return dict(
        params=params, layouts=layouts, v_slim=v_slim, v_meta=v_meta,
        sk=(np.asarray(sk.value.q), np.asarray(sk.value.p)),
        rlk=_gadget_np(rlk.gadget),
        gks={g: _gadget_np(k.gadget) for g, k in gks.items()},
        ct_slim=_ct_np(ct_slim), ct_meta=_ct_np(ct_meta),
        stages={k: _ct_np(o) for k, o in stages.items()},
        meta=_ct_np(out_meta))


def _carried(ct):
    value, _, scale = ct
    return interop.ciphertext_from_numpy(value, "cpu", scale=scale)


@pytest.fixture(scope="module")
def port(ref):
    """The port on the carried keys and ciphertexts: both evaluators, the
    slim stages and both outputs."""
    params = tckks.Parameters(tckks.ParametersLiteral(**LITERAL), device="cpu")
    enc = tckks.Encoder(params)
    ev = tckks.Evaluator(params, interop.evaluation_key_set_from_numpy(
        "cpu", rlk=ref["rlk"], galois_keys=ref["gks"]))
    std, slim = (tbts.BootstrappingEvaluator(params, ev, enc, _bts_params(
        tbts, tmod1, order)) for order in (tbts.MODUP_THEN_ENCODE,
                                            tbts.DECODE_THEN_MODUP))
    ct_slim, ct_meta = _carried(ref["ct_slim"]), _carried(ref["ct_meta"])
    stages = {}
    slim.bootstrap(ct_slim, on_stage=lambda name, c: stages.setdefault(name, c))
    meta = std.bootstrap_meta(ct_meta, iterations=META_ITERATIONS,
                              log_prec=META_LOG_PREC)
    sk = interop.secret_key_from_numpy(*ref["sk"], "cpu")
    dec = trlwe.Decryptor(params, sk)
    return dict(params=params, enc=enc, dec=dec, stages=stages, meta=meta,
                layouts={"std": _layout(std, ct_meta), "slim": _layout(slim, ct_slim)})


def _assert_ct_equal(got, want):
    """Tolerance 0 on the residues; the same level and exact scale."""
    value, level, scale = want
    assert (got.level, Fraction(got.scale)) == (level, scale)
    np.testing.assert_array_equal(interop.to_numpy(got.value), value)


@pytest.mark.parametrize("order", ["std", "slim"])
def test_layout_equal(ref, port, order):
    """Both orders' level layout, ModUp scalar, pinned EvalMod scale,
    level-scoped Galois elements and ScaleDown label, value for value."""
    assert port["params"].q_moduli == ref["params"].q_moduli
    assert port["layouts"][order] == ref["layouts"][order]


@pytest.mark.parametrize("stage", SLIM_STAGES)
def test_slim_stage_bit_equal(ref, port, stage):
    _assert_ct_equal(port["stages"][stage], ref["stages"][stage])


def test_meta_bit_equal(ref, port):
    _assert_ct_equal(port["meta"], ref["meta"])


@pytest.mark.parametrize("case", ["slim", "meta"])
def test_carried_precision(ref, port, case):
    """The bit-equal outputs decrypt to their inputs at the slow-tier floor."""
    out = port["stages"]["out"] if case == "slim" else port["meta"]
    got = port["enc"].decode(port["dec"].decrypt(out))
    bits = float(-np.log2(np.abs(got - ref[f"v_{case}"]).max()))
    assert bits >= MIN_BITS, f"{case}: {bits:.2f} bits"
