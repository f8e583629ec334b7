"""The comparison and inverse circuits on the real bootstrapper
(``CircuitBootstrapper`` over ``BootstrappingEvaluator``), the flow of
``chip_smoke.py`` phase 16 at ``N16QP1546_H192_H32`` cut to logN 8 (its
chain of 25 Q + 5 P primes and its recipe unchanged):

* the port makes its keys (``prepare_recipe``), encrypts x ∈ ±[2^-8, 1] at
  level 2, below an X4 stage's depth, and ``ComparisonEvaluator.sign``
  with one X4 stage bootstraps for real before the stage. The
  bootstrapped ciphertext (the stage's input, at the default scale) and the
  keys the stage uses (relinearization, conjugation) are carried to the JAX
  package, whose ``MinimaxCompositeEvaluator`` evaluates the stage under one
  ``jax.jit``: the port's output must be bit-equal to it (tolerance 0), at
  the same level and exact scale;
* the port's decrypted output against numpy's X4(x), at a floor of the JAX
  package's result on the CPU, same preset, logN, flow and inputs with its
  own keys, less one bit (19.86 / 23.77 bits - 1; ``python
  tests/test_torch_circuits_btp.py`` prints it, with the full-domain
  inverse's, the floors of phase 16);
* the bootstrapper's output at the default scale, one level below the
  pipeline's, and its counter.
"""

from dataclasses import replace
from fractions import Fraction
from pathlib import Path
import sys

import numpy as np
import jax
import pytest
import torch

from lattigo_tpu import rlwe as jrlwe
from lattigo_tpu.circuits import bootstrapping_presets as jbp, minimax as jmm
from lattigo_tpu.ring.ringqp import QPPoly as JQPPoly
from lattigo_tpu.schemes import ckks as jckks
from lattigo_tpu_torch import interop

ROOT = Path(__file__).resolve().parents[1]
LOG_N = 8
# the JAX package's sign stage on the CPU at logN 8 (reference_bits below)
# less one bit
SIGN_FLOOR = (18.86, 22.77)
# XLA's CPU backend at its lowest optimisation level: the program is
# integer-exact, so it changes no result, and it compiles faster
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def _chip_smoke():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sign():
    """The port's sign stage on the real bootstrapper, with the
    bootstrapper's output recorded."""
    cs = _chip_smoke()
    flow = cs.circuits_btp_flow("cpu", LOG_N)
    run, chk, btp = flow["circuits"]["sign stage"]
    boots = []
    inner = btp.bootstrap

    def recording(ct):
        boots.append(inner(ct))
        return boots[-1]

    btp.bootstrap = recording
    out = run()
    btp.bootstrap = inner
    return dict(flow=flow, out=out, bits=chk(out), boots=boots, btp=btp, cs=cs)


def test_sign_stage_bit_equal_to_jax(sign):
    flow, (bt,), out = sign["flow"], sign["boots"], sign["out"]
    pt = flow["params"]
    residual, lit = getattr(jbp, sign["cs"].BTP16_PRESET)
    full, _ = jbp.build_bootstrapping_parameters(replace(residual, log_n=LOG_N), lit)
    pj = jckks.Parameters(full)
    assert (pj.q_moduli, pj.p_moduli) == (pt.q_moduli, pt.p_moduli)
    evk = sign["flow"]["btp"].ev.evk
    conj = pt.galois_element_order_two
    rlk = interop.qp_to_numpy(evk.relinearization_key.gadget.value)
    gk = interop.qp_to_numpy(evk.galois_keys[conj].gadget.value)
    meta = {}

    def run(rlk, gk, v):
        jev = jckks.Evaluator(pj, jrlwe.EvaluationKeySet(
            jrlwe.RelinearizationKey(jrlwe.GadgetCiphertext(JQPPoly(*rlk))),
            {conj: jrlwe.GaloisKey(jrlwe.GadgetCiphertext(JQPPoly(*gk)), conj)}))
        res = jmm.MinimaxCompositeEvaluator(jev).evaluate(
            jrlwe.Ciphertext(value=v, scale=Fraction(bt.scale)), [jmm.SIGN_X4_CHEBY])
        meta["out"] = (res.level, Fraction(res.scale))
        return res.value

    ref = np.asarray(jax.jit(run, compiler_options=_FAST_COMPILE)(
        rlk, gk, interop.to_numpy(bt.value)))
    assert meta["out"] == (out.level, Fraction(out.scale))
    np.testing.assert_array_equal(interop.to_numpy(out.value), ref)


def test_sign_stage_precision(sign):
    worst, mean = sign["bits"]
    assert worst >= SIGN_FLOOR[0] and mean >= SIGN_FLOOR[1], sign["bits"]


def test_bootstrapper_output(sign):
    (bt,), btp = sign["boots"], sign["btp"]
    b = sign["flow"]["btp"]
    assert btp.counter == 1 and btp.minimum_input_level == 0
    assert bt.level == b.output_level - 1
    assert Fraction(bt.scale) == b.params.default_scale_fraction


# -- the floors of chip_smoke.py phase 16 ---------------------------------------

def reference_bits(log_n: int = LOG_N) -> dict:
    """The JAX package's phase-16 circuits on the CPU at ``BTP16_PRESET`` cut
    to ``log_n``, on its own keys (``run_recipe``'s draws): {circuit:
    (worst, mean) bits}. Its bootstraps run through ``jitted`` (one
    compiled pipeline per input level and scale), the evaluator's methods
    and each stage's polynomial as cached ``jax.jit`` programs."""
    import time

    from lattigo_tpu.circuits import (
        bootstrapping as jbts, comparison as jcmp, inverse as jinv,
    )
    from lattigo_tpu_torch.circuits.bootstrapping_presets import precision_bits
    from test_torch_comparison_inverse import _jit_methods

    cs = _chip_smoke()
    residual, lit = getattr(jbp, cs.BTP16_PRESET)
    full, bparams = jbp.build_bootstrapping_parameters(
        replace(residual, log_n=log_n), lit)
    params = jckks.Parameters(full)
    kgen = jrlwe.KeyGenerator(params)
    k_sk, k_rlk, k_gk, k_ct = jax.random.split(jax.random.PRNGKey(0), 4)
    sk = kgen.gen_secret_key(k_sk)
    rlk = kgen.gen_relinearization_key(k_rlk, sk)
    enc = jckks.Encoder(params)
    b = jbts.BootstrappingEvaluator(params, jckks.Evaluator(
        params, jrlwe.EvaluationKeySet(relinearization_key=rlk)), enc, bparams)
    gks = kgen.gen_galois_keys(k_gk, b.galois_elements(), sk,
                               levels=b.galois_element_levels())
    ev = jckks.Evaluator(params, jrlwe.EvaluationKeySet(relinearization_key=rlk,
                                                        galois_keys=gks))
    b.with_evaluator(ev)
    keys = b.gen_encapsulation_keys(jax.random.PRNGKey(7), sk)
    _jit_methods(ev, ["add", "sub", "neg", "mul_relin", "rescale", "mul_const",
                      "conjugate", "set_scale"])

    class Bootstrapper:
        """The port's CircuitBootstrapper, on the JAX package's pipeline."""

        def __init__(self, level):
            self.minimum_input_level, self.counter, self.fns = level, 0, {}

        def bootstrap(self, ct):
            key = (ct.level, Fraction(ct.scale), ct.value.shape)
            if key not in self.fns:
                self.fns[key] = b.jitted(ct, keys=keys)
            out = self.fns[key](ct)
            self.counter += 1
            if Fraction(out.scale) != params.default_scale_fraction:
                out = ev.set_scale(out, params.default_scale_fraction)
            return out

    x = cs.btp16_inputs(params.max_slots)
    dec = jrlwe.Decryptor(params, sk)
    encryptor = jrlwe.Encryptor(params, sk)
    k1, k2 = jax.random.split(k_ct)

    def decrypt(ct):
        return np.asarray(enc.decode(dec.decrypt(ct))).real

    out, t0 = {}, time.time()
    ce = jcmp.ComparisonEvaluator(ev, sign_polys=[jmm.SIGN_X4_CHEBY],
                                  bootstrapper=Bootstrapper(0))
    _jit_methods(ce.minimax.poly_eval, ["evaluate"])
    ct = encryptor.encrypt(k1, enc.encode(x["sign_x"])).at_level(cs.BTP16_SIGN_LEVEL)
    out["sign stage"] = precision_bits(decrypt(ce.sign(ct)), cs.x4_sign_stage(x["sign_x"]))
    print("sign stage", out["sign stage"], f"{time.time() - t0:.0f} s", flush=True)
    inv_btp = Bootstrapper(cs.CIRC_INV_MIN_LEVEL)
    inv = jinv.InverseEvaluator(ev, bootstrapper=inv_btp,
                                sign_polys=[jmm.SIGN_X4_CHEBY] * cs.CIRC_X4_STAGES)
    _jit_methods(inv.minimax.poly_eval, ["evaluate"])
    ct = encryptor.encrypt(k2, enc.encode(x["inv_x"])).at_level(b.output_level)
    out["inverse full domain"] = precision_bits(
        decrypt(inv.evaluate_full_domain(ct, -3.0, 2.0)) * x["inv_x"], 1.0)
    print("inverse full domain", out["inverse full domain"], f"{inv_btp.counter} "
          f"bootstraps, {time.time() - t0:.0f} s", flush=True)
    return out


if __name__ == "__main__":
    print(reference_bits(int(sys.argv[1]) if len(sys.argv) > 1 else LOG_N))
