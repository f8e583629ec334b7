"""CKKS walk-through: every basic operation, end to end.

Analog of the reference's examples/singleparty/tutorials/ckks: parameters,
key generation, encode/encrypt, add/sub, plaintext and ciphertext
multiplication with rescaling, rotations, conjugation, and decryption —
with precision printed at each step.

    python -m lattigo_tpu_torch.examples.ckks_tutorial
"""

import numpy as np
import torch

from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.schemes import ckks


def prec(enc, dec, ct, want, label):
    got = enc.decode(dec.decrypt(ct))
    stats = ckks.get_precision_stats(want, got)
    print(f"{label:34s} level={ct.level} avg={stats.avg_precision:.1f} bits")


def main(device=None):
    # 1. Parameters: ring degree 2^12, 4-level chain, Δ = 2^40
    params = ckks.Parameters(ckks.ParametersLiteral(
        log_n=12, log_q=(55, 40, 40, 40, 40), log_p=(55,),
        log_default_scale=40), device=device)
    log_qp = params.log_q_big() + np.log2(float(params.p_big_int()))
    print(f"logN={params.log_n}  slots={params.max_slots}  "
          f"levels={params.max_level}  logQP={log_qp:.0f}")

    # 2. Keys: secret, public, relinearization, rotation by 1, conjugation
    gen = torch.Generator(device=params.ring_q.device).manual_seed(0)
    kgen = rlwe.KeyGenerator(params)
    sk = kgen.gen_secret_key(gen)
    pk = kgen.gen_public_key(gen, sk)
    rlk = kgen.gen_relinearization_key(gen, sk)
    gal_els = [params.galois_element(1), params.galois_element_order_two]
    gks = kgen.gen_galois_keys(gen, gal_els, sk)
    evk = rlwe.EvaluationKeySet(relinearization_key=rlk, galois_keys=gks)

    enc = ckks.Encoder(params)
    encryptor = rlwe.Encryptor(params, pk)   # public-key encryption
    dec = rlwe.Decryptor(params, sk)
    ev = ckks.Evaluator(params, evk)

    # 3. Encode + encrypt two complex vectors
    rng = np.random.default_rng(1)
    shape = params.max_slots
    v1 = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    v2 = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    ct1 = encryptor.encrypt(gen, enc.encode(v1))
    ct2 = encryptor.encrypt(gen, enc.encode(v2))
    prec(enc, dec, ct1, v1, "fresh encryption")

    # 4. Additions: ct+ct, ct+pt, ct+scalar
    prec(enc, dec, ev.add(ct1, ct2), v1 + v2, "ct + ct")
    prec(enc, dec, ev.add(ct1, enc.encode(v2)), v1 + v2, "ct + pt")
    prec(enc, dec, ev.add(ct1, 0.5 + 0.25j), v1 + 0.5 + 0.25j, "ct + scalar")

    # 5. Multiplications (each consumes one level after rescale)
    prec(enc, dec, ev.rescale(ev.mul_relin(ct1, ct2)), v1 * v2,
         "ct * ct (relin + rescale)")
    prec(enc, dec, ev.rescale(ev.mul(ct1, enc.encode(v2))), v1 * v2,
         "ct * pt (rescale)")
    prec(enc, dec, ev.rescale(ev.mul_const(ct1, 1.0 / 3)), v1 / 3,
         "ct * scalar")

    # 6. Rotation and conjugation (Galois automorphisms)
    prec(enc, dec, ev.rotate(ct1, 1), np.roll(v1, -1), "rotate by 1")
    prec(enc, dec, ev.conjugate(ct1), np.conj(v1), "conjugate")

    # 7. Depth: ((v1^2)^2)^2 — three levels
    ct = ct1
    want = v1
    for _ in range(3):
        ct = ev.rescale(ev.mul_relin(ct, ct))
        want = want * want
    prec(enc, dec, ct, want, "depth-3 squaring chain")


if __name__ == "__main__":
    main()
