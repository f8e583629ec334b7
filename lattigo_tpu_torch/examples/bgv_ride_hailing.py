"""Oblivious ride hailing: encrypted nearest-driver search.

Analog of the reference's examples/singleparty/bgv_ride_hailing (the
ORide protocol, USENIX Security'17): a rider encrypts their grid
coordinates under an ephemeral key; each driver encodes their coordinates
in a designated slot and encrypts under the rider's public key; the
server homomorphically computes the squared distance to every driver in
SIMD, and only the rider can decrypt and pick the closest one.

    python -m lattigo_tpu_torch.examples.bgv_ride_hailing
"""

import numpy as np
import torch

from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.schemes import bgv


def main(n_drivers: int = 32, device=None):
    # plaintext modulus large enough for squared grid distances
    params = bgv.Parameters(bgv.ParametersLiteral(
        log_n=11, log_q=(48, 40, 40), log_p=(50,), t=65537), device=device)
    gen = torch.Generator(device=params.ring_q.device).manual_seed(0)
    kgen = rlwe.KeyGenerator(params)
    sk = kgen.gen_secret_key(gen)           # rider's ephemeral secret
    pk = kgen.gen_public_key(gen, sk)
    rlk = kgen.gen_relinearization_key(gen, sk)
    ev = bgv.Evaluator(params, rlwe.EvaluationKeySet(relinearization_key=rlk))
    enc = bgv.Encoder(params)
    encryptor = rlwe.Encryptor(params, pk)

    grid = 256
    rng = np.random.default_rng(7)
    rider = rng.integers(0, grid, 2)
    drivers = rng.integers(0, grid, (n_drivers, 2))

    # rider: (x, y) replicated into every slot
    rider_x = np.full(params.n, rider[0], dtype=np.int64)
    rider_y = np.full(params.n, rider[1], dtype=np.int64)
    ct_rx = encryptor.encrypt(gen, enc.encode(rider_x))
    ct_ry = encryptor.encrypt(gen, enc.encode(rider_y))

    # each driver: coordinates in their own slot, encrypted under rider pk;
    # the server sums them into one SIMD ciphertext per axis
    ct_dx = ct_dy = None
    for i in range(n_drivers):
        dx = np.zeros(params.n, dtype=np.int64)
        dy = np.zeros(params.n, dtype=np.int64)
        dx[i], dy[i] = drivers[i]
        ca = encryptor.encrypt(gen, enc.encode(dx))
        cb = encryptor.encrypt(gen, enc.encode(dy))
        ct_dx = ca if ct_dx is None else ev.add(ct_dx, ca)
        ct_dy = cb if ct_dy is None else ev.add(ct_dy, cb)

    # server: (xr - xd)^2 + (yr - yd)^2 per slot, one relinearized level
    dx = ev.sub(ct_rx, ct_dx)
    dy = ev.sub(ct_ry, ct_dy)
    dist = ev.add(ev.mul_relin(dx, dx), ev.mul_relin(dy, dy))
    dist = ev.rescale(dist)

    # rider decrypts and selects
    got = enc.decode(rlwe.Decryptor(params, sk).decrypt(dist)) % params.t
    d2 = got[:n_drivers].astype(np.int64)
    want = ((drivers - rider) ** 2).sum(axis=1)
    assert np.array_equal(d2, want % params.t), "distance mismatch"
    best = int(np.argmin(d2))
    print(f"rider at {tuple(rider)}: closest of {n_drivers} drivers is "
          f"#{best} at {tuple(drivers[best])}, d^2={d2[best]}")


if __name__ == "__main__":
    main()
