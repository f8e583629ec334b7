"""Slim CKKS bootstrapping: decode first, compute in the coefficient domain.

Analog of the reference's examples/singleparty/ckks_bootstrapping/slim —
the Chen-Han reordering (ia.cr/2018/067, also used by Kim & Guyot for
coefficient-domain convolutions in encrypted CNN inference):

standard order: circuit(slots) → ScaleDown → ModUp → C2S → EvalMod → S2C
slim order:     circuit(slots) → S2C → circuit(coeffs) → ScaleDown →
                ModUp → C2S → EvalMod → (back to slots)

Demo-sized parameters (logN=8, insecure) so it runs in seconds; the same
pipeline scales to the production logN=16 presets.

    python -m lattigo_tpu_torch.examples.ckks_bootstrapping_slim
"""

from fractions import Fraction

import numpy as np
import torch

from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.circuits import bootstrapping as bts
from lattigo_tpu_torch.circuits.mod1 import Mod1Parameters
from lattigo_tpu_torch.schemes import ckks


def main(device=None):
    # chain (bottom → top): q0(55) | S2C 2x45 | slots circuit 45 |
    # EvalMod 9x55 | C2S 2x55 — S2C sits at the bottom so the decoded
    # ciphertext lands at level 0 ready for ModUp.
    params = ckks.Parameters(ckks.ParametersLiteral(
        log_n=8,
        log_q=(55,) + (45,) * 3 + (55,) * 14,
        log_p=(60, 60),
        log_default_scale=45,
    ), device=device)
    gen = torch.Generator(device=params.ring_q.device).manual_seed(0)
    kgen = rlwe.KeyGenerator(params)
    sk = kgen.gen_secret_key(gen)
    rlk = kgen.gen_relinearization_key(gen, sk)
    enc = ckks.Encoder(params)
    ev0 = ckks.Evaluator(params, rlwe.EvaluationKeySet(relinearization_key=rlk))

    btp = bts.BootstrappingEvaluator(params, ev0, enc, bts.BootstrappingParameters(
        c2s_levels=[4, 3],
        s2c_levels=[4, 3],
        mod1=Mod1Parameters(k=16, degree=30, double_angle=4,
                            log_message_ratio=10),
        residual_levels=1,
        circuit_order=bts.DECODE_THEN_MODUP,
    ))
    gks = kgen.gen_galois_keys(gen, btp.galois_elements(), sk)
    ev = ckks.Evaluator(params, rlwe.EvaluationKeySet(
        relinearization_key=rlk, galois_keys=gks))
    btp.with_evaluator(ev)

    rng = np.random.default_rng(1)
    v = rng.uniform(-1, 1, params.max_slots) \
        + 1j * rng.uniform(-1, 1, params.max_slots)
    ct = rlwe.Encryptor(params, sk).encrypt(gen, enc.encode(v))

    # the slots-domain circuit runs down to the S2C entry level
    ct = ct.at_level(btp.minimum_input_level)
    print(f"slots-domain input:  level {ct.level}")

    # Step 1: SlotsToCoeffs — message moves to the polynomial coefficients.
    ct = btp.slots_to_coeffs(ct)

    # Step 2: circuit in the coefficient domain — multiply by the monomial
    # X^{N/2}, which is multiplication by i on the slot values
    # (ref slim example step 2). A negacyclic shift by N/2.
    n, ring = params.n, params.ring_q
    val = ring.intt(ct.value, ct.level) if ct.is_ntt else ct.value
    shifted = torch.roll(val, n // 2, dims=-1)
    wrap = torch.arange(n, device=val.device) < n // 2
    q = ring.q[: ct.level + 1]
    val = torch.where(wrap, torch.where(shifted == 0, shifted, q - shifted),
                      shifted)
    ct = ct.replace(value=ring.ntt(val, ct.level), is_ntt=True)

    # Steps 3-6: ScaleDown → ModUp → CoeffsToSlots → EvalMod.
    ct0 = btp.scale_down(ct)
    delta0, q0 = Fraction(ct0.scale), Fraction(params.q_moduli[0])
    up = btp.mod_up(ct0)
    ct_re, ct_im = btp.coeffs_to_slots(up)
    ct_re, ct_im = btp.eval_mod(ct_re), btp.eval_mod(ct_im)
    out = ev.add(ct_re, ev.mul_by_i(ct_im))
    out = out.replace(scale=Fraction(out.scale) * delta0 / q0)
    print(f"bootstrapped output: level {out.level} "
          f"(= btp.output_level {btp.output_level})")

    got = enc.decode(rlwe.Decryptor(params, sk).decrypt(out))
    err = np.abs(got - 1j * v).max()
    print(f"(slim bootstrap ∘ mul X^(N/2)) max err {err:.2e} "
          f"({-np.log2(err):.1f} bits)")
    assert -np.log2(err) >= 8.0


if __name__ == "__main__":
    main()
