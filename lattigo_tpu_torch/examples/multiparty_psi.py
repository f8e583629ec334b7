"""N-party private set intersection over encrypted bitmasks.

Analog of the reference's examples/multiparty/int_psi: parties agree on a
universe of item slots; each encrypts its membership bitmask under the
collective public key; the joint AND is the slot-wise product of all
ciphertexts; collective key switching to sk'=0 decrypts the intersection.
All "network" exchanges are in-process, as in the reference's example.
Each party draws from its own generator.

    python -m lattigo_tpu_torch.examples.multiparty_psi
"""

import numpy as np
import torch

from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.multiparty.protocols import (
    KeySwitchProtocol, PublicKeyGenProtocol, RelinearizationKeyGenProtocol,
)
from lattigo_tpu_torch.rlwe.keys import SecretKey
from lattigo_tpu_torch.schemes import bgv


def main(n_parties: int = 3, device=None):
    params = bgv.Parameters(bgv.ParametersLiteral(
        log_n=11, log_q=(45, 38, 38), log_p=(50,), t=65537), device=device)
    rng = np.random.default_rng(0)
    gens = [torch.Generator(device=params.ring_q.device).manual_seed(i)
            for i in range(n_parties)]
    kgen = rlwe.KeyGenerator(params)
    sks = [kgen.gen_secret_key(g) for g in gens]

    # --- collective public key (1 round) ------------------------------------
    cpk_proto = PublicKeyGenProtocol(params)
    crp = cpk_proto.sample_crp(b"psi-cpk-crs")
    shares = [cpk_proto.gen_share(gens[i], sks[i], crp)
              for i in range(n_parties)]
    agg = shares[0]
    for s in shares[1:]:
        agg = cpk_proto.aggregate_shares(agg, s)
    cpk = cpk_proto.finalize(agg, crp)

    # --- collective relinearization key (2 rounds) ---------------------------
    rlk_proto = RelinearizationKeyGenProtocol(params)
    crps = rlk_proto.sample_crp(b"psi-rlk-crs")
    eph = [rlk_proto.gen_ephemeral(g) for g in gens]
    r1 = [rlk_proto.gen_share_round1(gens[i], sks[i], eph[i], crps)
          for i in range(n_parties)]
    agg1 = r1[0]
    for s in r1[1:]:
        agg1 = rlk_proto.aggregate_shares(agg1, s)
    r2 = [rlk_proto.gen_share_round2(gens[i], sks[i], eph[i], agg1)
          for i in range(n_parties)]
    agg2 = r2[0]
    for s in r2[1:]:
        agg2 = rlk_proto.aggregate_shares(agg2, s)
    rlk = rlk_proto.finalize(agg1, agg2)

    # --- each party encrypts its membership bitmask --------------------------
    enc = bgv.Encoder(params)
    encryptor = rlwe.Encryptor(params, cpk)
    universe = params.n
    sets = [rng.integers(0, 2, universe, dtype=np.int64)
            for _ in range(n_parties)]
    cts = [encryptor.encrypt(gens[i], enc.encode(sets[i]))
           for i in range(n_parties)]

    # --- joint AND by multiplication ----------------------------------------
    ev = bgv.Evaluator(params, rlwe.EvaluationKeySet(relinearization_key=rlk))
    acc = cts[0]
    for c in cts[1:]:
        acc = ev.rescale(ev.mul_relin(acc, c))

    # --- collective decryption (key switch to sk' = 0) ------------------------
    cks = KeySwitchProtocol(params)
    dec_shares = [cks.gen_share(gens[i], sks[i], None, acc)
                  for i in range(n_parties)]
    dagg = dec_shares[0]
    for s in dec_shares[1:]:
        dagg = cks.aggregate_shares(dagg, s)
    plain = cks.key_switch(acc, dagg)

    # anyone can now decode with the zero key
    zero_sk = SecretKey(params.ring_qp.zero())
    got = np.asarray(enc.decode(
        rlwe.Decryptor(params, zero_sk).decrypt(plain))) % params.t
    want = sets[0]
    for s in sets[1:]:
        want = want & s
    assert np.array_equal(got, want), "PSI mismatch"
    print(f"{n_parties}-party PSI over {universe} items: "
          f"|intersection| = {int(got.sum())}, exact")


if __name__ == "__main__":
    main()
