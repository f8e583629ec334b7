"""Port parity for CKKS bootstrapping: the homomorphic DFT, the published
presets and the whole pipeline.

Host tables with tolerance 0: ``dft_level_diagonals`` (and the stages and
compositions it is made of) at logN 8–10, and, for all eight published
presets, the chain the builder assembles and the evaluator parameters it
derives, metadata only (the counterpart of ``tests/test_bootstrap_presets.py``).

Then the slice as a whole: ``N15QP768_H192_H32`` at logN 9, its chain and
radix splits unchanged. The JAX package makes the keys (secret,
relinearization, the level-scoped Galois keys of
``galois_element_levels()``, the two encapsulation keys) and the input
ciphertext, and runs its own bootstrap through ``jitted(...).stages`` once
(about 2.5 minutes with a cold XLA cache). The port, on the carried keys and
ciphertext, encodes its own DFT matrices and bootstraps; every encoded
matrix and each stage's output (``pre``, ``c2s`` re/im, ``mod1`` re/im, the
final ciphertext) must be bit-equal to the JAX package's (tolerance 0),
with the same exact ``Fraction`` scale and the same level; so must the
stages that the per-stage audit (``circuits/bootstrap_diag.py``, the
counterpart of ``diag_bootstrap_stages.py``) sees in one more bootstrap,
which reports every figure of the JAX script. Then the port's
own keys run its ``run_recipe`` at logN 9 against the JAX package's
slow-tier thresholds (worst ≥ 15.5, avg ≥ 17.5 bits), and
``SecretKeyBootstrapper`` refreshes to the top level. The sparse
``bootstrap_many`` and ``evaluate_conjugate_invariant`` (on the chain's CI
twin at logN 8) are held bit-equal to the JAX package's around one
stand-in bootstrap (so no second JAX bootstrap is compiled), on keys the
port makes from the carried secret, and then run on the port's real
bootstrap at the reference tests' floor of 8 bits;
``packing_galois_elements`` equals the JAX package's. The slim circuit
order and META-BTS, held against the JAX package, are
``tests/test_torch_bootstrap_orders.py``; the port alone, on its own keys
and with further options, is ``tests/test_torch_bootstrap_own.py``.
"""

import copy
from dataclasses import replace
from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

from lattigo_tpu import rlwe as jrlwe
from lattigo_tpu.circuits import (
    bootstrapping as jbts, bootstrapping_presets as jbp, dft as jdft,
)
from lattigo_tpu.ring.ringqp import QPPoly as JQPPoly
from lattigo_tpu.rlwe import ring_packing as jrp
from lattigo_tpu.schemes import ckks as jckks
from lattigo_tpu.schemes.ckks import bridge as jbridge
from lattigo_tpu_torch import interop, rlwe as trlwe
from lattigo_tpu_torch.circuits import (
    bootstrap_diag, bootstrapping as tbts, bootstrapping_presets as tbp, dft as tdft,
)
from lattigo_tpu_torch.ring.ring import CONJUGATE_INVARIANT
from lattigo_tpu_torch.schemes import ckks as tckks
from lattigo_tpu_torch.schemes.ckks import bridge as tbridge
from test_torch_ci_ring import FAST_COMPILE, jit_gadget_products, jitted_constant_ntts

LOG_N = 9
PRESET = "N15QP768_H192_H32"
# the JAX package's slow-tier thresholds at logN 9 (tests/test_preset_recipes.py)
MIN_WORST, MIN_AVG = 15.5, 17.5
PRESET_NAMES = ["N16QP1546_H192_H32", "N16QP1547_H192_H32",
                "N16QP1553_H192_H32", "N15QP768_H192_H32",
                "N16QP1767_H32768_H32", "N16QP1788_H32768_H32",
                "N16QP1793_H32768_H32", "N15QP880_H16384_H32"]
STAGES = ["pre", "c2s re", "c2s im", "mod1 re", "mod1 im", "out"]
# the sparse bootstrap_many: 2^6 slots, so 2^2 ciphertexts share one bootstrap
SPARSE_LOG_SLOTS = LOG_N - 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's ops here act on small tensors, where torch's intra-op
    threads only add overhead: one thread runs this file faster and leaves
    the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- host tables ---------------------------------------------------------------

def _assert_diags_equal(have, want):
    assert sorted(have) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k])


@pytest.mark.parametrize("log_n", [8, 9, 10])
def test_dft_level_diagonals_equal(log_n):
    n = 1 << (log_n - 1)                  # full-slot count
    logn = log_n - 1
    for m in (1 << s for s in range(logn)):
        for inverse in (False, True):
            _assert_diags_equal(tdft.stage_diagonals(n, m, inverse),
                                jdft.stage_diagonals(n, m, inverse))
    np.testing.assert_array_equal(tdft.bit_reversal_permutation(n),
                                  jdft.bit_reversal_permutation(n))
    splits = [[logn], tbp._radix_split(logn, 2), tbp._radix_split(logn, 3),
              [1] * logn]
    for levels in splits:
        assert tbp._radix_split(logn, len(levels)) == jbp._radix_split(logn, len(levels))
        for inverse in (False, True):
            for spl in (1.0, 0.5 / 16):
                have = tdft.dft_level_diagonals(n, levels, inverse, spl)
                want = jdft.dft_level_diagonals(n, levels, inverse, spl)
                assert len(have) == len(want)
                for h, w in zip(have, want):
                    _assert_diags_equal(h, w)


@pytest.mark.parametrize("name", PRESET_NAMES)
def test_preset_parameters_equal(name):
    """Every literal and the builder's output: the chain (log_q, log_p, xs,
    scale) and the evaluator parameters, field for field."""
    (tres, tlit), (jres, jlit) = getattr(tbp, name), getattr(jbp, name)
    for f in ("log_n", "log_q", "log_p", "log_default_scale"):
        assert getattr(tres, f) == getattr(jres, f)
    assert tres.xs.hamming_weight == jres.xs.hamming_weight
    assert vars(tlit) == vars(jlit)
    tfull, tb = tbp.build_bootstrapping_parameters(tres, tlit)
    jfull, jb = jbp.build_bootstrapping_parameters(jres, jlit)
    for f in ("log_n", "log_q", "log_p", "log_default_scale"):
        assert getattr(tfull, f) == getattr(jfull, f)
    assert tfull.xs.hamming_weight == jfull.xs.hamming_weight
    for f in ("c2s_levels", "s2c_levels", "residual_levels",
              "ephemeral_secret_weight", "circuit_order"):
        assert getattr(tb, f) == getattr(jb, f)
    assert vars(tb.mod1) == vars(jb.mod1)
    depth = tbts.BootstrappingEvaluator._mod1_depth(tb.mod1)
    assert depth == jbts.BootstrappingEvaluator._mod1_depth(jb.mod1)
    assert len(tfull.log_q) == (len(tb.c2s_levels) + depth + len(tb.s2c_levels)
                                + tb.residual_levels + 1)
    assert sum(tb.c2s_levels) == sum(tb.s2c_levels) == tres.log_n - 1
    assert (tbp.DEFAULT_PARAMETERS_SPARSE + tbp.DEFAULT_PARAMETERS_DENSE).index(
        getattr(tbp, name)) == PRESET_NAMES.index(name)


# -- the slice: N15QP768_H192_H32 at logN 9 on carried keys ------------------------

def _reduced(bp_mod):
    residual, lit = getattr(bp_mod, PRESET)
    return bp_mod.build_bootstrapping_parameters(
        replace(residual, log_n=LOG_N), lit)


def _gadget_np(gadget):
    return np.asarray(gadget.value.q), np.asarray(gadget.value.p)


def _lt_np(lt):
    return dict(vec={k: (np.asarray(v.q), np.asarray(v.p)) for k, v in lt.vec.items()},
                n1=lt.n1, level_q=lt.level_q, scale=Fraction(lt.scale),
                slots=lt.slots)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's keys, input and bootstrap stages (as run_recipe
    makes them), as numpy arrays and exact metadata."""
    full, btp = _reduced(jbp)
    params = jckks.Parameters(full)
    kgen = jrlwe.KeyGenerator(params)
    k_sk, k_rlk, k_gk, k_ct = jax.random.split(jax.random.PRNGKey(0), 4)
    sk = kgen.gen_secret_key(k_sk)
    rlk = kgen.gen_relinearization_key(k_rlk, sk)
    enc = jckks.Encoder(params)
    b = jbts.BootstrappingEvaluator(params, jckks.Evaluator(
        params, jrlwe.EvaluationKeySet(relinearization_key=rlk)), enc, btp)
    gks = kgen.gen_galois_keys(k_gk, b.galois_elements(), sk,
                               levels=b.galois_element_levels())
    b.with_evaluator(jckks.Evaluator(params, jrlwe.EvaluationKeySet(
        relinearization_key=rlk, galois_keys=gks)))
    keys = b.gen_encapsulation_keys(jax.random.PRNGKey(7), sk)
    rng = np.random.default_rng(1)
    v = (rng.uniform(-1, 1, params.max_slots)
         + 1j * rng.uniform(-1, 1, params.max_slots))
    ct = jrlwe.Encryptor(params, sk).encrypt(
        k_ct, enc.encode(v)).at_level(b.minimum_input_level)
    f = b.jitted(ct, keys=keys)
    st = f.stages
    outs = {"pre": st["pre"](ct)}
    outs["c2s re"], outs["c2s im"] = st["c2s"](outs["pre"])
    outs["mod1 re"] = st["mod1"](outs["c2s re"])
    outs["mod1 im"] = st["mod1"](outs["c2s im"])
    raw = st["s2c"](outs["mod1 re"], outs["mod1 im"])
    outs["out"] = raw.replace(scale=f.out_meta["scale"])
    return dict(
        params=params, btp=b, v=v,
        sk=(np.asarray(sk.value.q), np.asarray(sk.value.p)),
        rlk=_gadget_np(rlk.gadget),
        gks={g: _gadget_np(k.gadget) for g, k in gks.items()},
        d2s=_gadget_np(keys.evk_dense_to_sparse.gadget),
        s2d=_gadget_np(keys.evk_sparse_to_dense.gadget),
        ct=(np.asarray(ct.value), Fraction(ct.scale)),
        c2s=[_lt_np(lt) for lt in b.dft.c2s_mats],
        s2c=[_lt_np(lt) for lt in b.dft.s2c_mats],
        stages={k: (np.asarray(o.value), o.level, Fraction(o.scale))
                for k, o in outs.items()})


@pytest.fixture(scope="module")
def port(ref):
    """The port on the carried keys and ciphertext: its evaluator, its
    stage outputs and its decrypted final slots."""
    full, btp = _reduced(tbp)
    params = tckks.Parameters(full, device="cpu")
    enc = tckks.Encoder(params)
    rlk = interop.relinearization_key_from_numpy(*ref["rlk"], "cpu")
    b = tbts.BootstrappingEvaluator(params, tckks.Evaluator(
        params, trlwe.EvaluationKeySet(relinearization_key=rlk)), enc, btp)
    evk = interop.evaluation_key_set_from_numpy("cpu", rlk=ref["rlk"],
                                                galois_keys=ref["gks"])
    b.with_evaluator(tckks.Evaluator(params, evk))
    keys = interop.bootstrapping_keys_from_numpy(ref["d2s"], ref["s2d"], "cpu")
    value, scale = ref["ct"]
    ct = interop.ciphertext_from_numpy(value, "cpu", scale=scale)
    stages = {}
    out = b.bootstrap(ct, keys, on_stage=lambda name, c: stages.setdefault(name, c))
    sk = interop.secret_key_from_numpy(*ref["sk"], "cpu")
    got = enc.decode(trlwe.Decryptor(params, sk).decrypt(out))
    return dict(params=params, btp=b, stages=stages, out=out, got=got,
                sk=sk, enc=enc, ct=ct, keys=keys)


def test_layout_and_metadata_equal(ref, port):
    jb, tb = ref["btp"], port["btp"]
    assert port["params"].q_moduli == ref["params"].q_moduli
    assert port["params"].p_moduli == ref["params"].p_moduli
    assert tb.galois_elements() == jb.galois_elements()
    assert tb.galois_element_levels() == jb.galois_element_levels()
    for f in ("level_c2s_top", "level_mod1_top", "level_s2c_top",
              "minimum_input_level", "output_level", "_modup_scalar",
              "_mod1_scale"):
        assert getattr(tb, f) == getattr(jb, f), f
    assert tb.mod1._dc_bias == jb.mod1._dc_bias
    level, scale = ref["params"].max_level, Fraction(2) ** 25
    assert tb.scale_down_label(level, scale) == jb.scale_down_label(level, scale)
    for ring in (port["params"].ring_q, port["params"].ring_p):
        assert ring.ntt_engine == "radix2-plain"


@pytest.mark.parametrize("group", ["c2s", "s2c"])
def test_dft_matrices_bit_equal(ref, port, group):
    """Every encoded diagonal, NTT + Montgomery over QP: tolerance 0."""
    mats = getattr(port["btp"].dft, f"{group}_mats")
    assert len(mats) == len(ref[group])
    for lt, want in zip(mats, ref[group]):
        assert (lt.n1, lt.level_q, Fraction(lt.scale), lt.slots) == (
            want["n1"], want["level_q"], want["scale"], want["slots"])
        assert sorted(lt.vec) == sorted(want["vec"])
        for k, (q, p) in want["vec"].items():
            np.testing.assert_array_equal(interop.to_numpy(lt.vec[k].q), q)
            np.testing.assert_array_equal(interop.to_numpy(lt.vec[k].p), p)


@pytest.mark.parametrize("stage", STAGES)
def test_stage_bit_equal(ref, port, stage):
    """Tolerance 0 on the residues; the same level and exact scale."""
    value, level, scale = ref["stages"][stage]
    got = port["stages"][stage]
    assert (got.level, Fraction(got.scale)) == (level, scale)
    np.testing.assert_array_equal(interop.to_numpy(got.value), value)


@pytest.fixture(scope="module")
def audited(ref, port):
    """The per-stage audit (``diag_bootstrap_stages.py``'s counterpart) of
    one more bootstrap of the carried ciphertext."""
    return bootstrap_diag.audit(port["btp"], port["keys"], port["ct"], port["sk"],
                                ref["v"], PRESET)


@pytest.mark.parametrize("stage", STAGES)
def test_audit_stages_bit_equal(ref, audited, stage):
    """The stages the audit saw through ``on_stage`` are the JAX package's
    ``jitted(...).stages``: tolerance 0, the same level and exact scale."""
    value, level, scale = ref["stages"][stage]
    got = audited["stages"][stage]
    assert (got.level, Fraction(got.scale)) == (level, scale)
    np.testing.assert_array_equal(interop.to_numpy(got.value), value)


def test_audit_end_to_end(ref, port, audited):
    """Its decoded output and end-to-end bits are those of the decrypted
    bootstrap."""
    np.testing.assert_array_equal(audited["got"], port["got"])
    errs = np.abs(port["got"] - ref["v"])
    assert audited["end_to_end_bits"] == -np.log2(errs.max())
    assert audited["end_to_end_mean_bits"] == np.mean(-np.log2(np.maximum(errs, 2.0 ** -60)))
    assert audited["lines"][-2] == f"logN={LOG_N} {PRESET}: end-to-end " \
        f"{-np.log2(errs.max()):.1f} bits"


def test_audit_decomposition(audited):
    """The decomposition's terms (err_in, err_pre, err_s2c) and every other
    figure the JAX script prints are there, and EvalMod's output was found
    in the bit-reversed order that the split through S2C places it by.
    err_total = err_pre + err_s2c holds by construction (err_s2c is the
    rest), so the sum itself is not checked."""
    assert audited["post_evalmod"]["order"] == "bitrev"
    for key in ("encapsulation", "post_c2s", "post_evalmod_imag", "evalmod_split",
                "post_evalmod", "raw_s2c", "s2c_slot", "err_in", "err_pre",
                "err_pre_top", "err_pre_fits", "scalar_fit"):
        assert key in audited, key
    assert sorted(audited["evalmod_split"]) == ["approx", "ladder", "total"]
    assert all(line.startswith(f"logN={LOG_N} {PRESET}: ") for line in audited["lines"])
    assert len(audited["lines"]) == 15 + len(audited["err_pre_fits"])


def test_audit_refuses_slim_and_batches(port):
    """The slim order has no S2C stage to split, and the audit takes one
    ciphertext."""
    slim = SimpleNamespace(btp=SimpleNamespace(circuit_order=tbts.DECODE_THEN_MODUP))
    with pytest.raises(ValueError, match="order"):
        bootstrap_diag.audit(slim, None, port["ct"], port["sk"], None)
    batched = port["ct"].replace(value=port["ct"].value[None])
    with pytest.raises(ValueError, match="batch"):
        bootstrap_diag.audit(port["btp"], port["keys"], batched, port["sk"], None)


def test_carried_precision(ref, port):
    """The bit-equal output decrypts to the input at the slow-tier floor."""
    errs = np.abs(port["got"] - ref["v"])
    assert port["out"].level == port["btp"].output_level
    assert -np.log2(errs.max()) >= MIN_WORST
    assert np.mean(-np.log2(np.maximum(errs, 2.0 ** -60))) >= MIN_AVG


def test_own_keys_recipe():
    """The port's own keys (torch generators) at logN 9."""
    worst, avg = tbp.run_recipe(getattr(tbp, PRESET), log_n=LOG_N, device="cpu")
    assert worst >= MIN_WORST, f"worst {worst:.2f} < {MIN_WORST}"
    assert avg >= MIN_AVG, f"avg {avg:.2f} < {MIN_AVG}"


def test_secret_key_bootstrapper(port):
    params, enc = port["params"], port["enc"]
    gen = torch.Generator().manual_seed(3)
    skb = tbts.SecretKeyBootstrapper(params, enc, port["sk"], gen)
    rng = np.random.default_rng(4)
    v = rng.uniform(-1, 1, params.max_slots) + 1j * rng.uniform(-1, 1, params.max_slots)
    ct = trlwe.Encryptor(params, port["sk"]).encrypt(gen, enc.encode(v)).at_level(0)
    outs = skb.bootstrap_many([ct, ct])
    assert skb.counter == 2
    assert (skb.minimum_input_level, skb.output_level) == (0, params.max_level)
    for out in outs:
        assert out.level == params.max_level
        assert out.scale == params.default_scale_fraction
        got = enc.decode(trlwe.Decryptor(params, port["sk"]).decrypt(out))
        assert np.abs(got - v).max() < 2.0 ** -12


def test_bootstrap_many_full_slots(port):
    """A list of full-slot ciphertexts is bootstrapped one by one."""
    (out,) = port["btp"].bootstrap_many([port["ct"]], port["keys"])
    want = port["out"]
    assert (out.level, Fraction(out.scale)) == (want.level, Fraction(want.scale))
    assert torch.equal(out.value, want.value)


# -- the sparse and conjugate-invariant entry points ---------------------------

def test_packing_galois_elements_equal(ref, port):
    for log_slots in range(1, LOG_N - 1):
        assert (port["btp"].packing_galois_elements(log_slots)
                == ref["btp"].packing_galois_elements(log_slots))


def _standin(ev):
    """The bootstrap both packages' instances get for the bit-equality
    test: deterministic and cheap (no new JAX bootstrap is compiled)."""
    return lambda ct, keys=None: ev.add(ct, ct)


@pytest.fixture(scope="module")
def packing(ref, port):
    """The port's keys and inputs for the sparse and CI entry points, made
    from the carried secret: the level-scoped Galois keys of the pack tree
    at ``SPARSE_LOG_SLOTS`` (added to the port's evaluator), the chain's CI
    twin at logN 8 with its secret and ring-swap keys, 4 sparse and 2 CI
    ciphertexts at the minimum input level; and both packages' outputs of
    the two entry points with the stand-in bootstrap."""
    params, b, sk = port["params"], port["btp"], port["sk"]
    gen = torch.Generator().manual_seed(11)
    lvls = b.packing_galois_elements(SPARSE_LOG_SLOTS)
    have = b.galois_element_levels()
    new = {g: l for g, l in lvls.items() if g not in have}
    assert all(have[g] >= l for g, l in lvls.items() if g in have)
    gks = dict(b.ev.evk.galois_keys)
    gks.update(trlwe.KeyGenerator(params).gen_galois_keys(gen, sorted(new), sk, levels=new))
    b.with_evaluator(tckks.Evaluator(params, trlwe.EvaluationKeySet(
        relinearization_key=b.ev.evk.relinearization_key, galois_keys=gks)))
    ci_lit = dict(log_n=LOG_N - 1, q=tuple(params.q_moduli), p=tuple(params.p_moduli),
                  log_default_scale=params.log_default_scale, ring_type=CONJUGATE_INVARIANT)
    params_ci = tckks.Parameters(tckks.ParametersLiteral(**ci_lit), device="cpu")
    sk_ci = trlwe.KeyGenerator(params_ci).gen_secret_key(gen)
    s2c, c2s = tbridge.gen_ring_swap_keys(gen, params, sk, sk_ci)
    sw = tbridge.DomainSwitcher(params, params_ci, s2c, c2s)
    rng = np.random.default_rng(12)
    n_small = 1 << SPARSE_LOG_SLOTS
    sparse = [np.tile(rng.uniform(-1, 1, n_small) + 1j * rng.uniform(-1, 1, n_small),
                      params.max_slots // n_small) for _ in range(4)]
    enc, enc_ci = port["enc"], tckks.CIEncoder(params_ci)
    encr, encr_ci = trlwe.Encryptor(params, sk), trlwe.Encryptor(params_ci, sk_ci)
    level = b.minimum_input_level
    cts = [encr.encrypt(gen, enc.encode(v)).at_level(level) for v in sparse]
    reals = [rng.uniform(-1, 1, params_ci.max_slots) for _ in range(2)]
    cts_ci = [encr_ci.encrypt(gen, enc_ci.encode(v)).at_level(level) for v in reals]

    def entry_points(b, sw, cts, cts_ci):
        out = {f"sparse {i}": c for i, c in
               enumerate(b.bootstrap_many(cts, log_slots=SPARSE_LOG_SLOTS))}
        out["ci left"], out["ci right"] = b.evaluate_conjugate_invariant(*cts_ci, switcher=sw)
        return out

    tb = copy.copy(b)
    tb.bootstrap = _standin(b.ev)
    port_out = entry_points(tb, sw, cts, cts_ci)

    jparams = ref["params"]
    jparams_ci = jckks.Parameters(jckks.ParametersLiteral(**ci_lit))
    scales = {}

    def evk(key):
        return jrlwe.EvaluationKey(jrlwe.GadgetCiphertext(JQPPoly(*key)))

    def run(gks_np, s2c_np, c2s_np, values, values_ci):
        jb = copy.copy(ref["btp"])
        jb.ev = jit_gadget_products(jckks.Evaluator(jparams, jrlwe.EvaluationKeySet(
            galois_keys={g: jrlwe.GaloisKey(jrlwe.GadgetCiphertext(JQPPoly(*k)), g)
                         for g, k in gks_np.items()})))
        jb.bootstrap = _standin(jb.ev)
        jsw = jbridge.DomainSwitcher(jparams, jparams_ci, evk(s2c_np), evk(c2s_np))
        jit_gadget_products(jsw.ev)
        out = entry_points(
            jb, jsw, [jrlwe.Ciphertext(value=v, scale=c.scale) for v, c in zip(values, cts)],
            [jrlwe.Ciphertext(value=v, scale=c.scale) for v, c in zip(values_ci, cts_ci)])
        scales.update({k: Fraction(c.scale) for k, c in out.items()})
        return {k: c.value for k, c in out.items()}

    with jitted_constant_ntts((jrp.RingPackingEvaluator, "_x_pow_mont"),
                              (jckks.Evaluator, "_i_monomial")):
        values = jax.jit(run, compiler_options=FAST_COMPILE)(
            {g: interop.qp_to_numpy(gks[g].gadget.value) for g in lvls},
            interop.qp_to_numpy(s2c.gadget.value), interop.qp_to_numpy(c2s.gadget.value),
            [interop.to_numpy(c.value) for c in cts], [interop.to_numpy(c.value) for c in cts_ci])
    ref_out = {k: (np.asarray(v), scales[k]) for k, v in values.items()}
    return dict(params_ci=params_ci, sk_ci=sk_ci, sw=sw, sparse=sparse, reals=reals,
                cts=cts, cts_ci=cts_ci, port=port_out, ref=ref_out)


@pytest.mark.parametrize("name", ["sparse 0", "sparse 1", "sparse 2", "sparse 3",
                                  "ci left", "ci right"])
def test_entry_points_bit_equal(packing, name):
    """Sparse bootstrap_many (pack, bootstrap, unpack) and
    evaluate_conjugate_invariant around the same stand-in bootstrap:
    tolerance 0, equal scales."""
    got = packing["port"][name]
    value, scale = packing["ref"][name]
    assert Fraction(got.scale) == scale
    np.testing.assert_array_equal(interop.to_numpy(got.value), value)


def test_own_sparse_bootstrap_many(port, packing):
    """4 sparse ciphertexts (2^SPARSE_LOG_SLOTS slots, replicated) share one
    real bootstrap of the port and come back at the reference tests'
    floor of 8 bits."""
    b, params = port["btp"], port["params"]
    outs = b.bootstrap_many(packing["cts"], port["keys"], log_slots=SPARSE_LOG_SLOTS)
    assert len(outs) == 4
    dec = trlwe.Decryptor(params, port["sk"])
    for v, out in zip(packing["sparse"], outs):
        assert out.level >= b.output_level
        got = port["enc"].decode(dec.decrypt(out))
        assert -np.log2(np.abs(got - v).max()) >= 8.0


def test_own_conjugate_invariant_pair(port, packing):
    """Two CI ciphertexts ride one real bootstrap of the port as its real
    and imaginary halves, at the reference tests' floor of 8 bits."""
    b = port["btp"]
    outs = b.evaluate_conjugate_invariant(*packing["cts_ci"], switcher=packing["sw"],
                                          keys=port["keys"])
    params_ci = packing["params_ci"]
    dec = trlwe.Decryptor(params_ci, packing["sk_ci"])
    enc = tckks.CIEncoder(params_ci)
    for v, out in zip(packing["reals"], outs):
        assert out.n == params_ci.n and out.level >= b.output_level
        got = enc.decode(dec.decrypt(out))
        assert -np.log2(np.abs(got - v).max()) >= 8.0
