"""Programmable bootstrapping: LMKCDEY blind rotation of a sign LUT.

Analog of the reference's examples/singleparty/rgsw_blind_rotations:
values encrypted as LWE coefficients are pushed through an arbitrary
function (here sign(x)) by rotating an encrypted test polynomial with
RGSW external products (ia.cr/2022/198; ref core/rgsw/blindrot).

    python -m lattigo_tpu_torch.examples.rgsw_blind_rotations
"""

import torch

from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.rgsw import blindrot


def sign(x):
    return 1.0 if x > 0 else (-1.0 if x < 0 else 0.0)


def main(device=None):
    # blind-rotation ring and small LWE ring
    params_br = rlwe.Parameters(rlwe.ParametersLiteral(
        log_n=9, log_q=(28,), log_p=(32,)), device=device)
    params_lwe = rlwe.Parameters(rlwe.ParametersLiteral(
        log_n=7, log_q=(14,), log_p=(15,)), device=device)

    gen = torch.Generator(device=params_br.ring_q.device).manual_seed(0)
    sk_lwe = rlwe.KeyGenerator(params_lwe).gen_secret_key(gen)
    sk_br = rlwe.KeyGenerator(params_br).gen_secret_key(gen)

    q_lwe = params_lwe.q_moduli[0]
    q_br = params_br.q_moduli[0]
    scale_lwe = q_lwe / 4.0
    scale_br = q_br / 4.0
    slots = 16

    values = [-1 + 2 * i / slots for i in range(slots)]
    coeffs = [0] * params_lwe.n
    for i, v in enumerate(values):
        coeffs[i] = int(round(v * scale_lwe))
    pt_poly = params_lwe.ring_q.ntt(
        params_lwe.ring_q.from_int_coeffs(coeffs, 0), 0)
    ct = rlwe.Encryptor(params_lwe, sk_lwe).encrypt(
        gen, rlwe.Plaintext(value=pt_poly, is_ntt=True))

    # the encrypted LUT: sign over [-1, 1]
    f = blindrot.init_test_polynomial(sign, scale_br, params_br, -1.0, 1.0)
    test_polys = {i: f for i in range(slots)}

    brk = blindrot.gen_evaluation_keys(gen, params_br, sk_br,
                                       params_lwe, sk_lwe)
    ev = blindrot.BlindRotationEvaluator(params_br, params_lwe)
    out = ev.evaluate(ct, test_polys, brk)

    dec = rlwe.Decryptor(params_br, sk_br)
    print(" x      sign(x)  blindrot")
    for i, v in enumerate(values):
        ptb = dec.decrypt(out[i])
        c = int(params_br.ring_q.intt(ptb.value, ptb.level)[0, 0])
        a = (c - q_br if c >= q_br // 2 else c) / scale_br
        print(f"{v:+.3f}   {sign(v):+.0f}      {a:+.3f}")


if __name__ == "__main__":
    main()
