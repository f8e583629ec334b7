"""Vectorized oblivious linear evaluation over Z_T: receiver learns a·x+b.

Analog of the reference's examples/singleparty/bgv_vectorized_ole.
The receiver encrypts x; the sender computes a⊙ct+b homomorphically
(never seeing x); the receiver decrypts a⊙x+b (never seeing a, b).

    python -m lattigo_tpu_torch.examples.bgv_vectorized_ole
"""

import numpy as np
import torch

from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.schemes import bgv


def main(device=None):
    params = bgv.Parameters(bgv.ParametersLiteral(
        log_n=11, log_q=(45, 38), log_p=(50,), t=65537), device=device)
    gen = torch.Generator(device=params.ring_q.device).manual_seed(0)
    kgen = rlwe.KeyGenerator(params)
    sk = kgen.gen_secret_key(gen)
    enc = bgv.Encoder(params)
    t = params.t
    rng = np.random.default_rng(2)

    # receiver
    x = rng.integers(0, t, params.n, dtype=np.int64)
    ct = rlwe.Encryptor(params, sk).encrypt(gen, enc.encode(x))

    # sender (public-key-free demo: operates on the ciphertext only)
    a = rng.integers(0, t, params.n, dtype=np.int64)
    b = rng.integers(0, t, params.n, dtype=np.int64)
    ev = bgv.Evaluator(params)
    out = ev.add(ev.mul(ct, enc.encode(a)), enc.encode(b))

    # receiver decrypts
    got = np.asarray(enc.decode(rlwe.Decryptor(params, sk).decrypt(out))) % t
    want = (a.astype(object) * x + b) % t
    assert np.array_equal(got, want.astype(np.int64))
    print(f"OLE over Z_{t}: {params.n} slots, exact")


if __name__ == "__main__":
    main()
