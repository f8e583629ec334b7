"""Encrypted sigmoid: CKKS + degree-15 Chebyshev evaluation.

Analog of the reference's examples/singleparty/ckks_sigmoid_chebyshev.

    python -m lattigo_tpu_torch.examples.ckks_sigmoid
"""

import math

import numpy as np
import torch

from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.circuits.polynomial import PolynomialEvaluator, chebyshev_approximate
from lattigo_tpu_torch.schemes import ckks


def main(device=None):
    params = ckks.Parameters(ckks.ParametersLiteral(
        log_n=11, log_q=(55,) + (45,) * 8, log_p=(60,), log_default_scale=45),
        device=device)
    gen = torch.Generator(device=params.ring_q.device).manual_seed(0)
    kgen = rlwe.KeyGenerator(params)
    sk = kgen.gen_secret_key(gen)
    rlk = kgen.gen_relinearization_key(gen, sk)
    ev = ckks.Evaluator(params, rlwe.EvaluationKeySet(relinearization_key=rlk))
    enc = ckks.Encoder(params)

    sigmoid = lambda x: 1.0 / (1.0 + math.exp(-x))
    poly = chebyshev_approximate(lambda t: sigmoid(8.0 * t), 15, (-1.0, 1.0))

    rng = np.random.default_rng(1)
    x = rng.uniform(-8, 8, params.max_slots)
    ct = rlwe.Encryptor(params, sk).encrypt(gen, enc.encode(x / 8.0))

    out = PolynomialEvaluator(ev).evaluate(ct, poly)

    got = np.real(enc.decode(rlwe.Decryptor(params, sk).decrypt(out)))
    want = np.array([sigmoid(v) for v in x])
    err = np.abs(got - want).max()
    print(f"sigmoid on {params.max_slots} encrypted values: max err {err:.2e}")


if __name__ == "__main__":
    main()
