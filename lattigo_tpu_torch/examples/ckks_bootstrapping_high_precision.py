"""High-precision CKKS bootstrapping via META-BTS iterations.

Analog of the reference's examples/singleparty/ckks_bootstrapping/
high_precision: each extra bootstrapping iteration refreshes the *error*
of the previous one (scaled up by 2^log_prec), gaining ~log_prec bits of
output precision per round (META-BTS, ia.cr/2022/1167). Demo-sized
parameters (logN=8, insecure) so it runs in seconds.

    python -m lattigo_tpu_torch.examples.ckks_bootstrapping_high_precision
"""

import numpy as np
import torch

from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.circuits import bootstrapping as bts
from lattigo_tpu_torch.circuits.mod1 import Mod1Parameters
from lattigo_tpu_torch.schemes import ckks


def main(device=None):
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
    btp.with_evaluator(ckks.Evaluator(params, rlwe.EvaluationKeySet(
        relinearization_key=rlk, galois_keys=gks)))

    rng = np.random.default_rng(1)
    v = rng.uniform(-1, 1, params.max_slots) \
        + 1j * rng.uniform(-1, 1, params.max_slots)
    ct = rlwe.Encryptor(params, sk).encrypt(gen, enc.encode(v)).at_level(0)
    dec = rlwe.Decryptor(params, sk)

    base = btp.bootstrap(ct)
    err1 = np.abs(enc.decode(dec.decrypt(base)) - v).max()
    print(f"1 iteration : {-np.log2(err1):5.1f} bits")

    prev = err1
    for iters in (2, 3):
        out = btp.bootstrap_meta(ct, iterations=iters, log_prec=6)
        err = np.abs(enc.decode(dec.decrypt(out)) - v).max()
        print(f"{iters} iterations: {-np.log2(err):5.1f} bits")
        assert err < prev, "META-BTS iteration did not improve precision"
        prev = err
    print("META-BTS: each iteration adds ~log_prec bits, as expected")


if __name__ == "__main__":
    main()
