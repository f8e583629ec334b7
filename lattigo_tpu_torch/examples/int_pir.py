"""N-party private information retrieval over an encrypted database.

Analog of the reference's examples/multiparty/int_pir: each party uploads
an encrypted integer row to a helper; a querier sends an encrypted one-hot
selector; the helper computes Σ_i mask_i·row_i under encryption — where
mask_i replicates the i-th selector slot to every slot via InnerSum — and
the parties collectively key-switch the response for the querier. Uses
collective public/relinearization/Galois keys (all "network" exchanges
in-process, as in the reference's example). Each party draws from its own
generator.

    python -m lattigo_tpu_torch.examples.int_pir
"""

import numpy as np
import torch

from lattigo_tpu_torch import multiparty as mp
from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.schemes import bgv


def aggregate(proto, shares):
    agg = shares[0]
    for s in shares[1:]:
        agg = proto.aggregate_shares(agg, s)
    return agg


def main(n_parties: int = 4, device=None):
    params = bgv.Parameters(bgv.ParametersLiteral(
        log_n=10, log_q=(45, 38, 38), log_p=(50,), t=65537), device=device)
    slots = params.n // 2          # one row of the BGV slot matrix
    dev = params.ring_q.device
    gens = [torch.Generator(device=dev).manual_seed(i) for i in range(n_parties)]
    kgen = rlwe.KeyGenerator(params)
    sks = [kgen.gen_secret_key(g) for g in gens]

    # --- collective keys ------------------------------------------------------
    cpk_proto = mp.PublicKeyGenProtocol(params)
    crp = cpk_proto.sample_crp(b"pir-cpk")
    cpk = cpk_proto.finalize(aggregate(cpk_proto, [
        cpk_proto.gen_share(g, sk, crp) for g, sk in zip(gens, sks)]), crp)

    rlk_proto = mp.RelinearizationKeyGenProtocol(params)
    crps = rlk_proto.sample_crp(b"pir-rlk")
    eph = [rlk_proto.gen_ephemeral(g) for g in gens]
    agg1 = aggregate(rlk_proto, [
        rlk_proto.gen_share_round1(g, sk, e, crps)
        for g, sk, e in zip(gens, sks, eph)])
    agg2 = aggregate(rlk_proto, [
        rlk_proto.gen_share_round2(g, sk, e, agg1)
        for g, sk, e in zip(gens, sks, eph)])
    rlk = rlk_proto.finalize(agg1, agg2)

    # Galois keys for slot replication (InnerSum over the full row)
    ev0 = bgv.Evaluator(params)
    gal_els = ev0.galois_elements_for_inner_sum(1, slots)
    gk_proto = mp.GaloisKeyGenProtocol(params)
    gks = {}
    for gal_el in gal_els:
        crps_g = gk_proto.sample_crp(f"pir-gk-{gal_el}".encode())
        agg = aggregate(gk_proto, [
            gk_proto.gen_share(g, gal_el, sk, crps_g) for g, sk in zip(gens, sks)])
        gks[gal_el] = gk_proto.finalize(gal_el, agg, crps_g)

    evk = rlwe.EvaluationKeySet(relinearization_key=rlk, galois_keys=gks)
    ev = bgv.Evaluator(params, evk)
    enc = bgv.Encoder(params)
    encryptor = rlwe.Encryptor(params, cpk)

    # --- each party uploads an encrypted row ---------------------------------
    rng = np.random.default_rng(1)
    rows = [rng.integers(0, params.t, params.n, dtype=np.int64)
            for _ in range(n_parties)]
    db = [encryptor.encrypt(g, enc.encode(r)) for g, r in zip(gens, rows)]

    # --- the querier asks for row `target` without revealing it --------------
    target = min(2, n_parties - 1)
    selector = np.zeros(params.n, dtype=np.int64)
    selector[target] = 1
    querier = torch.Generator(device=dev).manual_seed(n_parties)
    ct_query = encryptor.encrypt(querier, enc.encode(selector))

    # --- helper: response = Σ_i replicate(query[i]) · row_i -------------------
    response = None
    for i in range(n_parties):
        e_i = np.zeros(params.n, dtype=np.int64)
        e_i[i] = 1
        # isolate slot i of the query, then spread it to every slot
        mask = ev.mul(ct_query, enc.encode(e_i))
        mask = ev.inner_sum(mask, 1, slots)
        prod = ev.mul_relin(mask, db[i])
        response = prod if response is None else ev.add(response, prod)
    response = ev.rescale(response)

    # --- collective decryption for the querier (key switch to sk'=0) ---------
    cks = mp.KeySwitchProtocol(params)
    dagg = aggregate(cks, [
        cks.gen_share(g, sk, None, response) for g, sk in zip(gens, sks)])
    plain = cks.key_switch(response, dagg)
    zero_sk = rlwe.SecretKey(params.ring_qp.zero())
    got = enc.decode(
        rlwe.Decryptor(params, zero_sk).decrypt(plain)) % params.t

    want = rows[target] % params.t
    ok = np.array_equal(got[:slots], want[:slots])
    print(f"PIR over {n_parties} encrypted rows, query row {target}: "
          f"{'OK' if ok else 'MISMATCH'}")
    assert ok


if __name__ == "__main__":
    main()
