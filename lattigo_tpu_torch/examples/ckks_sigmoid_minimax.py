"""Encrypted sigmoid via a Remez (minimax) polynomial approximation.

Analog of the reference's examples/singleparty/ckks_sigmoid_minimax: the
same circuit as ckks_sigmoid.py but with the optimal minimax polynomial
from the multi-interval Remez exchange (utils/minimax.py, ref
utils/bignum/minimax_approximation.go) instead of Chebyshev interpolation
— lower worst-case error at the same degree.

    python -m lattigo_tpu_torch.examples.ckks_sigmoid_minimax
"""

import math

import numpy as np
import torch

from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.circuits.polynomial import (
    PolynomialEvaluator, chebyshev_approximate,
)
from lattigo_tpu_torch.schemes import ckks
from lattigo_tpu_torch.utils.minimax import remez


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
    target = lambda t: sigmoid(8.0 * t)
    deg = 15
    poly_mm = remez(target, [(-1.0, 1.0)], deg)
    poly_ch = chebyshev_approximate(target, deg, (-1.0, 1.0))

    rng = np.random.default_rng(1)
    x = rng.uniform(-8, 8, params.max_slots)
    encryptor = rlwe.Encryptor(params, sk)
    dec = rlwe.Decryptor(params, sk)
    want = np.array([sigmoid(v) for v in x])

    pe = PolynomialEvaluator(ev)
    for name, poly in [("chebyshev", poly_ch), ("minimax", poly_mm)]:
        ct = encryptor.encrypt(gen, enc.encode(x / 8.0))
        out = pe.evaluate(ct, poly)
        got = np.real(enc.decode(dec.decrypt(out)))
        err = np.abs(got - want).max()
        print(f"sigmoid, degree-{deg} {name:9s}: max err {err:.3e} "
              f"({-np.log2(err):.1f} bits)")


if __name__ == "__main__":
    main()
