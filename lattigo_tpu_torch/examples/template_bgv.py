"""Starter template: BGV encode/encrypt/decrypt/decode round trip.

Analog of the reference's examples/singleparty/templates/bgv: 128-bit
secure parameters, key generation, slot encoding of integers mod T,
encryption, decryption and exact decoding — the minimal skeleton to
copy-paste and build an application from.

    python -m lattigo_tpu_torch.examples.template_bgv
"""

import numpy as np
import torch

from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.schemes import bgv


def main(device=None):
    # 128-bit secure parameters (logN=14, logQP=431 — same set as the
    # reference template), plaintext modulus T = 0x10001.
    params = bgv.Parameters(bgv.ParametersLiteral(
        log_n=14,                                  # log2(ring degree)
        log_q=(55, 45, 45, 45, 45, 45, 45, 45),    # ciphertext modulus
        log_p=(61,),                               # key-switch auxiliary
        t=0x10001,                                 # plaintext modulus
    ), device=device)

    gen = torch.Generator(device=params.ring_q.device).manual_seed(0)
    kgen = rlwe.KeyGenerator(params)
    sk = kgen.gen_secret_key(gen)

    encoder = bgv.Encoder(params)
    encryptor = rlwe.Encryptor(params, sk)
    decryptor = rlwe.Decryptor(params, sk)

    # Vector of plaintext values, uniform mod T.
    rng = np.random.default_rng(0)
    want = rng.integers(0, params.t, params.max_slots, dtype=np.uint64)

    pt = encoder.encode(want)
    ct = encryptor.encrypt(gen, pt)
    have = encoder.decode(decryptor.decrypt(ct))

    print(f"logN={params.log_n} slots={params.max_slots} "
          f"levels={params.max_level + 1} T={params.t:#x}")
    print("Have:", " ".join(str(x) for x in have[:4]), "...")
    print("Want:", " ".join(str(x) for x in want[:4]), "...")
    assert np.array_equal(np.asarray(have, dtype=np.uint64), want), (
        "wrong result: bad decryption")
    print("exact round trip: OK")


if __name__ == "__main__":
    main()
