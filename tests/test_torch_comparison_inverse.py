"""Port parity for the minimax composite, comparison and inverse circuits.

At the reference tests' parameters (``tests/test_minimax_inverse.py``:
logN 8, Q 55 + 45 x 9, P 60, scale 2^45) with their composite, the Remez
stages of ``gen_minimax_composite_sign(6, [15, 15])`` and two X4 stages:

* **stage by stage, bit-equal**: the port makes the keys (secret,
  relinearization, conjugation) and encrypts each stage's input (numpy's
  value of the stages before it); carried to the JAX package, which
  evaluates each composite stage alone, one ``ComparisonEvaluator.step``
  (the fold into stage 0), one Goldschmidt iteration and one
  ``interval_normalization`` round, without a bootstrapper, under one
  ``jax.jit``, the port must give the same residues (tolerance 0), the
  same level and the same exact ``Fraction`` scale (a stage's scale is read
  at its conjugate addition, before the composite's relabel). Stages 0, 1
  and 3 run in the slow tier;
* **across secret-key bootstraps, precision**: a bootstrap draws fresh
  randomness, which ``jax.random`` cannot share, so the port's whole
  circuits (its own keys, encryption and ``SecretKeyBootstrapper``) are
  held against numpy at the reference tests' thresholds.

``python tests/test_torch_comparison_inverse.py`` runs the JAX package's
circuits of ``chip_smoke.py`` phase 8 on the CPU at the card's parameters
and prints their precision: the floors of that phase.
"""

from fractions import Fraction

import numpy as np
import jax
import pytest
import torch

from lattigo_tpu import rlwe as jrlwe
from lattigo_tpu.circuits import comparison as jcmp, inverse as jinv, minimax as jmm
from lattigo_tpu.ring.ringqp import QPPoly as JQPPoly
from lattigo_tpu.schemes import ckks as jckks
from lattigo_tpu.utils import minimax as jmin
from lattigo_tpu_torch import interop, rlwe as trlwe
from lattigo_tpu_torch.circuits import comparison as tcmp, inverse as tinv, minimax as tmm
from lattigo_tpu_torch.circuits.bootstrapping import SecretKeyBootstrapper
from lattigo_tpu_torch.schemes import ckks as tckks
from lattigo_tpu_torch.utils import minimax as tmin

LIT = dict(log_n=8, log_q=(55,) + (45,) * 9, log_p=(60,), log_default_scale=45)

# XLA's CPU backend at its lowest optimisation level: these programs are
# integer-exact, so it changes no result, and they compile several times
# faster
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sign_polys(mod_min, mod_mm):
    return list(mod_min.gen_minimax_composite_sign(6, [15, 15])) + [mod_mm.SIGN_X4_CHEBY] * 2


class _Recording:
    """Wraps an evaluator's ``add`` to keep the (level, scale) of its last
    output: a composite stage's conjugate addition, read before the
    composite relabels the scale."""

    def __init__(self, ev):
        self.last = None
        add = ev.add

        def recording(*a):
            out = add(*a)
            self.last = (out.level, Fraction(out.scale))
            return out

        ev.add = recording


def _pieces(cmp, inv, mm, ev, polys, cts, names):
    """The bootstrap-free pieces ``names``, each on its own carried input:
    composite stage k alone ("stage<k>"), ``step`` with the (x+1)/2 fold
    into stage 0, one Goldschmidt iteration, one normalization round."""
    rec = _Recording(ev)
    out, meta = {}, {}
    for name in names:
        if name.startswith("stage"):
            k = int(name[5:])
            out[name] = mm.MinimaxCompositeEvaluator(ev).evaluate(cts[name], [polys[k]])
            meta[name] = rec.last
        elif name == "step":
            ce = cmp.ComparisonEvaluator(ev, sign_polys=polys[:1])
            out[name] = ce.step(cts["stage0"])
            meta[name] = rec.last
        elif name == "goldschmidt":
            out[name] = inv.InverseEvaluator(ev).goldschmidt_division(cts["gold"],
                                                                       iterations=2)
        else:
            out["norm"], out["fac"] = inv.InverseEvaluator(ev).interval_normalization(
                cts["norm"], 1.0)
    for k in ("goldschmidt", "norm", "fac"):
        if k in out:
            meta[k] = (out[k].level, Fraction(out[k].scale))
    return out, meta


def _inputs(slots):
    """Each stage's input: x ∈ ±[2^-6, 1], then numpy's value of the stages
    before it; Goldschmidt's x ∈ [2^-4, 1]; normalization's |x| ≤ 2."""
    rng = np.random.default_rng(21)
    x = rng.uniform(2.0 ** -6, 1.0, slots) * rng.choice([-1.0, 1.0], slots)
    vals = {}
    for k, poly in enumerate(_sign_polys(tmin, tmm)):
        vals[f"stage{k}"] = x
        x = np.polynomial.chebyshev.chebval(x, np.asarray(poly.coeffs)).real
    vals["gold"] = rng.uniform(2.0 ** -4, 1.0, slots)
    vals["norm"] = rng.uniform(-2.0, 2.0, slots)
    return vals


@pytest.fixture(scope="module")
def state():
    """The port's keys (secret, relinearization, conjugation) and one
    ciphertext of each input, carried to the JAX package as numpy."""
    pt = tckks.Parameters(tckks.ParametersLiteral(**LIT), device="cpu")
    pj = jckks.Parameters(jckks.ParametersLiteral(**LIT))
    assert (pt.q_moduli, pt.p_moduli) == (pj.q_moduli, pj.p_moduli)
    gen = torch.Generator().manual_seed(4)
    kg = trlwe.KeyGenerator(pt)
    sk = kg.gen_secret_key(gen)
    conj = pt.galois_element_order_two
    evk = trlwe.EvaluationKeySet(kg.gen_relinearization_key(gen, sk),
                                 kg.gen_galois_keys(gen, [conj], sk))
    enc, encryptor = tckks.Encoder(pt), trlwe.Encryptor(pt, sk)
    vals = _inputs(pt.max_slots)
    cts = {k: encryptor.encrypt(gen, enc.encode(v)) for k, v in vals.items()}
    gk = evk.galois_keys[conj].gadget.value
    arrays = dict(rlk=interop.qp_to_numpy(evk.relinearization_key.gadget.value),
                  gk=interop.qp_to_numpy(gk),
                  cts={k: interop.to_numpy(c.value) for k, c in cts.items()})
    return dict(pt=pt, pj=pj, sk=sk, evk=evk, cts=cts, arrays=arrays, vals=vals,
                conj=conj)


def _compare(state, names):
    """The pieces ``names`` by the JAX package under one jit and by the
    port, on the same keys and ciphertexts."""
    pj, pt, a, conj = state["pj"], state["pt"], state["arrays"], state["conj"]
    scale = pj.default_scale_fraction
    meta = {}

    def run(rlk, gk, cts):
        evk = jrlwe.EvaluationKeySet(
            jrlwe.RelinearizationKey(jrlwe.GadgetCiphertext(JQPPoly(*rlk))),
            {conj: jrlwe.GaloisKey(jrlwe.GadgetCiphertext(JQPPoly(*gk)), conj)})
        out, m = _pieces(jcmp, jinv, jmm, jckks.Evaluator(pj, evk),
                         _sign_polys(jmin, jmm),
                         {k: jrlwe.Ciphertext(value=v, scale=scale) for k, v in cts.items()},
                         names)
        meta.update(m)
        return {k: o.value for k, o in out.items()}

    ref = jax.tree_util.tree_map(np.asarray, jax.jit(run, compiler_options=_FAST_COMPILE)(
        a["rlk"], a["gk"], a["cts"]))
    port, port_meta = _pieces(tcmp, tinv, tmm, tckks.Evaluator(pt, state["evk"]),
                              _sign_polys(tmin, tmm), state["cts"], names)
    return dict(ref=ref, meta=meta, port=port, port_meta=port_meta)


# tier 1: an X4 stage, the step fold on the degree-15 Remez stage 0, one
# Goldschmidt iteration and one normalization round; the JAX package's
# degree-15 stages alone take ~50 s each to trace and compile, so the other
# stages run in the slow tier
FAST = ["stage2", "step", "goldschmidt", "norm"]
SLOW = ["stage0", "stage1", "stage3"]


@pytest.fixture(scope="module")
def fast(state):
    return _compare(state, FAST)


@pytest.fixture(scope="module")
def slow(state):
    return _compare(state, SLOW)


def _bit_equal(res, name):
    got = res["port"][name]
    assert res["port_meta"][name] == res["meta"][name]
    assert got.level == res["meta"][name][0]
    np.testing.assert_array_equal(interop.to_numpy(got.value), res["ref"][name])


@pytest.mark.parametrize("name", ["stage2", "step", "goldschmidt", "norm", "fac"])
def test_piece_bit_equal(fast, name):
    """Tolerance 0 on the residues; equal level and exact scale."""
    _bit_equal(fast, name)


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW)
def test_stage_bit_equal(slow, name):
    _bit_equal(slow, name)


def test_pieces_decrypt(state, fast):
    """The port's pieces, decrypted, against numpy: the X4 stage, the folded
    step, Goldschmidt's (2 − x)(1 + (1 − x)²) and the normalization's
    factor 1 − (c·x)² with c = 2/√27."""
    pt, vals, out = state["pt"], state["vals"], fast["port"]
    enc, dec = tckks.Encoder(pt), trlwe.Decryptor(pt, state["sk"])
    polys = _sign_polys(tmin, tmm)
    cheb = np.polynomial.chebyshev.chebval

    def err(name, want):
        return np.abs(enc.decode(dec.decrypt(out[name])).real - want).max()

    assert err("stage2", cheb(vals["stage2"], np.asarray(polys[2].coeffs)).real) < 2.0 ** -30
    assert err("step", (cheb(vals["stage0"], np.asarray(polys[0].coeffs)).real + 1) / 2) \
        < 2.0 ** -30
    x = vals["gold"]
    assert err("goldschmidt", (2 - x) * (1 + (1 - x) ** 2)) < 2.0 ** -30
    x = vals["norm"]
    fac = 1 - (2.0 / np.sqrt(27.0) * x) ** 2
    assert err("fac", fac) < 2.0 ** -30
    assert err("norm", x * fac) < 2.0 ** -30


# -- whole circuits across secret-key bootstraps (the port alone) -------------

@pytest.fixture(scope="module")
def own():
    pt = tckks.Parameters(tckks.ParametersLiteral(**LIT), device="cpu")
    gen = torch.Generator().manual_seed(0)
    kg = trlwe.KeyGenerator(pt)
    sk = kg.gen_secret_key(gen)
    evk = trlwe.EvaluationKeySet(
        kg.gen_relinearization_key(gen, sk),
        kg.gen_galois_keys(gen, [pt.galois_element_order_two], sk))
    enc = tckks.Encoder(pt)
    encryptor, decryptor = trlwe.Encryptor(pt, sk), trlwe.Decryptor(pt, sk)
    return dict(
        pt=pt, sk=sk, ev=tckks.Evaluator(pt, evk),
        btp=SecretKeyBootstrapper(pt, enc, sk, torch.Generator().manual_seed(99)),
        enc=lambda v: encryptor.encrypt(gen, enc.encode(v)),
        dec=lambda ct: enc.decode(decryptor.decrypt(ct)).real)


def _signed(rng, lo, hi, n):
    return rng.uniform(lo, hi, n) * rng.choice([-1.0, 1.0], n)


def test_sign_across_bootstraps(own):
    n = own["pt"].max_slots
    v = _signed(np.random.default_rng(1), 2.0 ** -6, 1.0, n)
    mce = tmm.MinimaxCompositeEvaluator(own["ev"], own["btp"])
    assert mce.galois_elements() == [own["pt"].galois_element_order_two]
    before = own["btp"].counter
    out = mce.evaluate(own["enc"](v), _sign_polys(tmin, tmm))
    assert own["btp"].counter > before
    assert np.max(np.abs(own["dec"](out) - np.sign(v))) < 2.0 ** -22


def test_step_and_extrema_across_bootstraps(own):
    n = own["pt"].max_slots
    rng = np.random.default_rng(3)
    v = _signed(rng, 2.0 ** -5, 1.0, n)
    ce = tcmp.ComparisonEvaluator(own["ev"], sign_polys=list(
        tcmp.default_composite_sign_polys(5, (15, 15), 2)), bootstrapper=own["btp"])
    assert np.max(np.abs(own["dec"](ce.step(own["enc"](v))) - (np.sign(v) + 1) / 2)) \
        < 2.0 ** -18
    a = rng.uniform(-0.5, 0.5, n)
    b = a - _signed(rng, 2.0 ** -5, 1.0, n)
    ca, cb = own["enc"](a), own["enc"](b)
    assert np.max(np.abs(own["dec"](ce.max(ca, cb)) - np.maximum(a, b))) < 2.0 ** -18
    assert np.max(np.abs(own["dec"](ce.min(ca, cb)) - np.minimum(a, b))) < 2.0 ** -18


@pytest.mark.parametrize("level", [0, 1])
def test_minimum_input_level_plans_bootstraps(own, level):
    """The composite bootstraps before a stage that would end below the
    bootstrapper's minimum input level: X4 stages (depth 3) from level 9
    end at 6, 3, 0 at level 0 and at 6, 3, (bootstrap) 6, 3 at level 1."""
    pt, enc = own["pt"], own["enc"]
    btp = SecretKeyBootstrapper(pt, tckks.Encoder(pt), own["sk"],
                                torch.Generator().manual_seed(5), minimum_input_level=level)
    assert btp.minimum_input_level == level
    mce = tmm.MinimaxCompositeEvaluator(own["ev"], btp)
    ends = []
    evaluate = mce.poly_eval.evaluate

    def recording(ct, poly, target):
        out = evaluate(ct, poly, target)
        ends.append(out.level)
        return out

    mce.poly_eval.evaluate = recording
    v = _signed(np.random.default_rng(13), 2.0 ** -2, 1.0, pt.max_slots)
    out = mce.evaluate(enc(v), [tmm.SIGN_X4_CHEBY] * 4)
    assert ends == ([6, 3, 0, 6] if level == 0 else [6, 3, 6, 3])
    assert btp.counter == 1
    assert np.max(np.abs(own["dec"](out) - np.sign(v))) < 2.0 ** -10


def test_goldschmidt_across_bootstraps(own):
    v = np.random.default_rng(5).uniform(2.0 ** -4, 1.0, own["pt"].max_slots)
    inv = tinv.InverseEvaluator(own["ev"], bootstrapper=own["btp"])
    out = inv.goldschmidt_division(own["enc"](v), log2min=-4.0)
    assert np.max(np.abs((own["dec"](out) - 1.0 / v) * v)) < 2.0 ** -15


def test_interval_normalization_across_bootstraps(own):
    v = np.random.default_rng(7).uniform(-(2.0 ** 3), 2.0 ** 3, own["pt"].max_slots)
    inv = tinv.InverseEvaluator(own["ev"], bootstrapper=own["btp"])
    norm, fac = inv.interval_normalization(own["enc"](v), 3.0)
    got_norm, got_fac = own["dec"](norm), own["dec"](fac)
    assert np.max(np.abs(got_norm)) <= 1.0 + 1e-3
    assert np.max(np.abs(got_norm - v * got_fac)) < 1e-3


@pytest.mark.parametrize("domain", ["positive", "negative", "full"])
def test_inverse_domains_across_bootstraps(own, domain):
    n = own["pt"].max_slots
    rng = np.random.default_rng({"positive": 9, "negative": 10, "full": 11}[domain])
    v = rng.uniform(2.0 ** -3, 2.0 ** 2, n)
    inv = tinv.InverseEvaluator(own["ev"], bootstrapper=own["btp"],
                                sign_polys=_sign_polys(tmin, tmm))
    if domain == "positive":
        out = inv.evaluate_positive_domain(own["enc"](v), -3.0, 2.0)
    elif domain == "negative":
        v = -v
        out = inv.evaluate_negative_domain(own["enc"](v), -3.0, 2.0)
    else:
        v *= rng.choice([-1.0, 1.0], n)
        out = inv.evaluate_full_domain(own["enc"](v), -3.0, 2.0)
    assert np.max(np.abs((own["dec"](out) - 1.0 / v) * v)) < 2.0 ** -10


# -- the floors of chip_smoke.py phase 8 --------------------------------------

def _static_key(a):
    """A constant argument's cache key: its value where it is hashable (a
    scale or a scalar), else its identity (a polynomial)."""
    try:
        hash(a)
    except TypeError:
        return (type(a), id(a))
    return (type(a), a)


def _jit_methods(obj, names):
    """Replace ``obj``'s methods ``names`` (ciphertexts and hashable
    constants in, one ciphertext out) by ``jax.jit`` programs cached on
    their arguments' shapes and metadata. Eager JAX at logN 14 compiles op
    by op (~170 s a ``mul_relin`` at each new level); one jit of it takes
    ~9 s, and the values are the method's own."""
    for name in names:
        orig = getattr(obj, name)
        cache = {}

        def method(*args, _orig=orig, _cache=cache, **kw):
            cts = [a for a in args if isinstance(a, jrlwe.Ciphertext)]
            if any(isinstance(c.value, jax.core.Tracer) for c in cts):
                return _orig(*args, **kw)        # inside another method's jit
            key = tuple((a.value.shape, a.is_ntt, a.is_montgomery, Fraction(a.scale))
                        if isinstance(a, jrlwe.Ciphertext) else _static_key(a)
                        for a in args) + tuple((k, _static_key(v)) for k, v in sorted(kw.items()))
            if key not in _cache:
                meta = {}

                def run(values):
                    it = iter(values)
                    out = _orig(*(a.replace(value=next(it))
                                  if isinstance(a, jrlwe.Ciphertext) else a for a in args),
                                **kw)
                    meta["out"] = out
                    return out.value

                _cache[key] = (jax.jit(run), meta)
            fn, meta = _cache[key]
            value = fn([c.value for c in cts])      # traces first: sets meta
            return meta["out"].replace(value=value)

        setattr(obj, name, method)


def reference_circuit_bits(log_n: int = 14):
    """The JAX package's phase-8 CKKS circuits on the CPU at the card's
    parameters (``chip_smoke.circuits_flow``'s chains, composites, inputs and
    SK bootstrappers; keys under one ``jax.jit``, the circuits eagerly):
    {circuit: (worst, mean) bits}."""
    import dataclasses
    import sys
    import time
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from lattigo_tpu import presets as jpresets
    from lattigo_tpu.circuits.bootstrapping import SecretKeyBootstrapper as JSK
    from lattigo_tpu_torch.circuits.bootstrapping_presets import precision_bits

    class LevelledSK(JSK):
        """The JAX package's SK bootstrapper reporting a minimum input level."""

        def __init__(self, *a, level=0):
            super().__init__(*a)
            self.level = level

        @property
        def minimum_input_level(self):
            return self.level

    cp = jckks.Parameters(jpresets.ckks_tpu_params(log_n, cs.LOG_QP))
    ip = jckks.Parameters(dataclasses.replace(getattr(jpresets, cs.CIRC_INV_PRESET),
                                              log_n=log_n))
    x = cs.circuits_inputs(1 << log_n, 65537, cp.max_slots, ip.max_slots)

    def keys(p, seed, level):
        kg = jrlwe.KeyGenerator(p)
        conj = p.galois_element_order_two

        def gen(key):
            k1, k2, k3 = jax.random.split(key, 3)
            sk = kg.gen_secret_key(k1)
            return sk, kg.gen_relinearization_key(k2, sk), kg.gen_galois_key(k3, conj, sk)

        sk, rlk, gk = jax.jit(gen)(jax.random.PRNGKey(seed))
        ev = jckks.Evaluator(p, jrlwe.EvaluationKeySet(rlk, {conj: gk}))
        _jit_methods(ev, ["add", "sub", "neg", "mul_relin", "rescale", "mul_const",
                          "conjugate", "set_scale"])
        enc, dec = jckks.Encoder(p), jrlwe.Decryptor(p, sk)
        e = jrlwe.Encryptor(p, sk)
        btp = LevelledSK(p, enc, sk, jax.random.PRNGKey(seed + 1), level=level)
        keys_ = iter(jax.random.split(jax.random.PRNGKey(seed + 2), 8))
        return (ev, btp, lambda v: e.encrypt(next(keys_), enc.encode(v)),
                lambda ct: np.asarray(enc.decode(dec.decrypt(ct))).real)

    out = {}
    ev, btp, enc, dec = keys(cp, 1, 0)
    ce = jcmp.ComparisonEvaluator(ev, sign_polys=[jmm.SIGN_X4_CHEBY] * cs.CIRC_X4_STAGES,
                                  bootstrapper=btp)
    _jit_methods(ce.minimax.poly_eval, ["evaluate"])
    t0 = time.time()
    out["step"] = precision_bits(dec(ce.step(enc(x["step_x"]))),
                                 (np.sign(x["step_x"]) + 1) / 2)
    print("step", out["step"], f"{time.time() - t0:.0f} s", flush=True)
    out["max"] = precision_bits(dec(ce.max(enc(x["max_a"]), enc(x["max_b"]))),
                                np.maximum(x["max_a"], x["max_b"]))
    print("max", out["max"], f"{time.time() - t0:.0f} s", flush=True)
    inv = jinv.InverseEvaluator(ev, bootstrapper=btp)
    out["goldschmidt"] = precision_bits(
        dec(inv.goldschmidt_division(enc(x["gold_x"]), log2min=-4.0)) * x["gold_x"], 1.0)
    print("goldschmidt", out["goldschmidt"], f"{time.time() - t0:.0f} s", flush=True)
    ev, btp, enc, dec = keys(ip, 2, cs.CIRC_INV_MIN_LEVEL)
    inv = jinv.InverseEvaluator(ev, bootstrapper=btp,
                                sign_polys=[jmm.SIGN_X4_CHEBY] * cs.CIRC_X4_STAGES)
    _jit_methods(inv.minimax.poly_eval, ["evaluate"])
    out["inverse full domain"] = precision_bits(
        dec(inv.evaluate_full_domain(enc(x["inv_x"]), -3.0, 2.0)) * x["inv_x"], 1.0)
    print("inverse full domain", out["inverse full domain"],
          f"{time.time() - t0:.0f} s", flush=True)
    # why the phase's sign is X4 stages (printed, not a floor): step with
    # a Remez composite
    ev, btp, enc, dec = keys(cp, 3, 0)
    remez = list(jmin.gen_minimax_composite_sign(8, [15, 15, 15])) + [jmm.SIGN_X4_CHEBY] * 2
    ce = jcmp.ComparisonEvaluator(ev, sign_polys=remez, bootstrapper=btp)
    _jit_methods(ce.minimax.poly_eval, ["evaluate"])
    bits = precision_bits(dec(ce.step(enc(x["step_x"]))), (np.sign(x["step_x"]) + 1) / 2)
    print("step, gen_minimax_composite_sign(8, [15, 15, 15]) + 2 X4", bits,
          f"{time.time() - t0:.0f} s", flush=True)
    return out


if __name__ == "__main__":
    import sys
    print(reference_circuit_bits(int(sys.argv[1]) if len(sys.argv) > 1 else 14))
