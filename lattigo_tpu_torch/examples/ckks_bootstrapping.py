"""CKKS bootstrapping basics: refresh an exhausted ciphertext.

Analog of the reference's examples/singleparty/ckks_bootstrapping/basics:
encrypt, consume every level, bootstrap back to a usable level, and keep
computing. Demo-sized parameters (logN=8, insecure) so it runs in seconds;
the same pipeline scales to the production logN=16 presets.

    python -m lattigo_tpu_torch.examples.ckks_bootstrapping
"""

import numpy as np
import torch

from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.circuits import bootstrapping as bts
from lattigo_tpu_torch.circuits.mod1 import Mod1Parameters
from lattigo_tpu_torch.schemes import ckks


def main(device=None):
    # chain (bottom -> top): q0 | residual x3 | S2C 2x45 | EvalMod 11x55 | C2S
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
    ))
    gks = kgen.gen_galois_keys(gen, btp.galois_elements(), sk)
    ev = ckks.Evaluator(params, rlwe.EvaluationKeySet(
        relinearization_key=rlk, galois_keys=gks))
    btp.with_evaluator(ev)

    rng = np.random.default_rng(1)
    v = rng.uniform(-1, 1, params.max_slots) \
        + 1j * rng.uniform(-1, 1, params.max_slots)
    ct = rlwe.Encryptor(params, sk).encrypt(gen, enc.encode(v))

    # burn all levels
    ct = ct.at_level(0)
    print(f"before bootstrap: level {ct.level}")

    ct = btp.bootstrap(ct)
    print(f"after bootstrap:  level {ct.level} "
          f"(min usable {btp.minimum_input_level})")

    # the refreshed ciphertext supports arithmetic again
    ct2 = ev.rescale(ev.mul_relin(ct, ct))
    dec = rlwe.Decryptor(params, sk)
    got = enc.decode(dec.decrypt(ct2))
    err = np.abs(got - v * v).max()
    print(f"(bootstrap -> square) max err {err:.2e} "
          f"({-np.log2(err):.1f} bits)")


if __name__ == "__main__":
    main()
