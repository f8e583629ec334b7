"""Vectorized polynomial evaluation: different polynomials per slot.

Analog of the reference's examples/singleparty/ckks_vectorized_polynomial_
evaluation: the two sigmoid-gradient polynomials g0, g1 are evaluated in a
SINGLE Paterson-Stockmeyer pass, g0 on the even slots and g1 on the odd
slots, by replacing scalar coefficient multiplies with plaintext
slot-vector multiplies (PolynomialVector). Demo-sized parameters (logN=9,
insecure) so it runs in seconds.

    python -m lattigo_tpu_torch.examples.ckks_vectorized_polynomial_evaluation
"""

import math

import numpy as np
import torch

from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.circuits.polynomial import (
    PolynomialEvaluator, PolynomialVector, chebyshev_approximate,
)
from lattigo_tpu_torch.schemes import ckks


def main(device=None):
    params = ckks.Parameters(ckks.ParametersLiteral(
        log_n=9,
        log_q=(55,) + (45,) * 9,
        log_p=(61,),
        log_default_scale=45,
    ), device=device)
    gen = torch.Generator(device=params.ring_q.device).manual_seed(0)
    kgen = rlwe.KeyGenerator(params)
    sk = kgen.gen_secret_key(gen)
    rlk = kgen.gen_relinearization_key(gen, sk)
    enc = ckks.Encoder(params)
    ev = ckks.Evaluator(params, rlwe.EvaluationKeySet(relinearization_key=rlk))

    # samples in [-K, K]
    K = 25.0
    slots = params.max_slots
    rng = np.random.default_rng(1)
    values = rng.uniform(-K, K, slots)
    ct = rlwe.Encryptor(params, sk).encrypt(gen, enc.encode(values))

    # g0 = f'(x)(f(x)-0), g1 = f'(x)(f(x)-1) for f = sigmoid (the two
    # per-label gradients of logistic regression)
    def sigmoid(x):
        return 1.0 / (math.exp(-x) + 1.0)

    def g0(x):
        y = sigmoid(x)
        return y * (1 - y) * (y - 0)

    def g1(x):
        y = sigmoid(x)
        return y * (1 - y) * (y - 1)

    pv = PolynomialVector(
        [chebyshev_approximate(g0, 63, (-K, K)),
         chebyshev_approximate(g1, 63, (-K, K))],
        {0: list(range(0, slots, 2)),    # g0 on even slots
         1: list(range(1, slots, 2))})   # g1 on odd slots

    # change of basis [-K, K] -> [-1, 1] for the Chebyshev power basis
    ct = ev.rescale(ev.mul_const(ct, 1.0 / K))

    out = PolynomialEvaluator(ev, encoder=enc).evaluate(ct, pv)

    got = enc.decode(rlwe.Decryptor(params, sk).decrypt(out)).real
    want = pv.evaluate_plain(values.astype(np.complex128)).real
    err = np.abs(got - want).max()
    print(f"g0(even)/g1(odd) slots, degree-63 Chebyshev, one pass: "
          f"max err {err:.2e} ({-np.log2(err):.1f} bits)")
    assert err < 1e-4


if __name__ == "__main__":
    main()
