"""Starter template: CKKS encode/encrypt/decrypt/decode round trip.

Analog of the reference's examples/singleparty/templates/ckks: 128-bit
secure parameters enabling depth-7 circuits, key generation, encoding,
encryption, decryption and decoding — the minimal skeleton to copy-paste
and build an application from.

    python -m lattigo_tpu_torch.examples.template_ckks
"""

import numpy as np
import torch

from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.schemes import ckks


def main(device=None):
    # 128-bit secure parameters enabling depth-7 circuits (logN=14,
    # logQP=431 — same set as the reference template).
    params = ckks.Parameters(ckks.ParametersLiteral(
        log_n=14,                                  # log2(ring degree)
        log_q=(55, 45, 45, 45, 45, 45, 45, 45),    # ciphertext modulus
        log_p=(61,),                               # key-switch auxiliary
        log_default_scale=45,                      # log2(scale)
    ), device=device)

    gen = torch.Generator(device=params.ring_q.device).manual_seed(0)
    kgen = rlwe.KeyGenerator(params)
    sk = kgen.gen_secret_key(gen)

    encoder = ckks.Encoder(params)
    encryptor = rlwe.Encryptor(params, sk)
    decryptor = rlwe.Decryptor(params, sk)

    # Vector of plaintext values, uniform in [-1, 1] (complex slots).
    rng = np.random.default_rng(0)
    want = (rng.uniform(-1, 1, params.max_slots)
            + 1j * rng.uniform(-1, 1, params.max_slots))

    pt = encoder.encode(want)
    ct = encryptor.encrypt(gen, pt)
    have = encoder.decode(decryptor.decrypt(ct))

    stats = ckks.get_precision_stats(want, have)
    print(f"logN={params.log_n} slots={params.max_slots} "
          f"levels={params.max_level + 1} scale=2^{params.log_default_scale}")
    print(f"round-trip precision: avg {stats.avg_precision:.2f} bits "
          f"(min {stats.min_precision:.2f})")
    assert stats.avg_precision > 30


if __name__ == "__main__":
    main()
