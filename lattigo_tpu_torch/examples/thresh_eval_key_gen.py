"""t-out-of-N threshold generation of evaluation keys.

Analog of the reference's examples/multiparty/thresh_eval_key_gen: N
parties Shamir-share their secret-key shares (ia.cr/2022/780); any t of
them can later come online, recombine *additive* shares of the ideal
secret, and run the collective key-generation protocols (public key,
relinearization key) plus collective decryption — the N-t offline parties
are not needed. Each party draws from its own generator.

    python -m lattigo_tpu_torch.examples.thresh_eval_key_gen
"""

import numpy as np
import torch

from lattigo_tpu_torch import multiparty as mp
from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.ring.ringqp import QPPoly
from lattigo_tpu_torch.schemes import bgv


def aggregate(proto, shares):
    agg = shares[0]
    for s in shares[1:]:
        agg = proto.aggregate_shares(agg, s)
    return agg


def main(n_parties: int = 5, t: int = 3, device=None):
    params = bgv.Parameters(bgv.ParametersLiteral(
        log_n=10, log_q=(45, 38, 38), log_p=(50,), t=65537), device=device)
    gens = [torch.Generator(device=params.ring_q.device).manual_seed(i)
            for i in range(n_parties)]
    kgen = rlwe.KeyGenerator(params)
    sks = [kgen.gen_secret_key(g) for g in gens]

    # --- offline phase: every party Shamir-shares its additive sk share ----
    th = mp.Thresholdizer(params)
    points = list(range(1, n_parties + 1))     # public Shamir evaluation points
    polys = [th.gen_shamir_polynomial(g, t, sk) for g, sk in zip(gens, sks)]
    shamir_shares = []                         # party j's aggregated share
    for x in points:
        agg = th.gen_shamir_secret_share(x, polys[0])
        for poly in polys[1:]:
            agg = mp.Thresholdizer.aggregate_shares(
                params, agg, th.gen_shamir_secret_share(x, poly))
        shamir_shares.append(agg)

    # --- online phase: only t parties show up -------------------------------
    active = list(np.linspace(0, n_parties - 1, t, dtype=int))
    active_points = [points[i] for i in active]
    agens = [gens[i] for i in active]
    comb = mp.Combiner(params, t)
    # each active party locally derives an additive share of sk_ideal
    tsks = []
    for i in active:
        add = comb.gen_additive_share(active_points, points[i],
                                      shamir_shares[i])
        tsks.append(rlwe.SecretKey(QPPoly(add.value.q, add.value.p)))

    # collective public key from the t additive shares
    cpk_proto = mp.PublicKeyGenProtocol(params)
    crp = cpk_proto.sample_crp(b"thresh-cpk")
    cpk = cpk_proto.finalize(aggregate(cpk_proto, [
        cpk_proto.gen_share(g, s, crp) for g, s in zip(agens, tsks)]), crp)

    # collective relinearization key (2 rounds) from the t additive shares
    rlk_proto = mp.RelinearizationKeyGenProtocol(params)
    crps = rlk_proto.sample_crp(b"thresh-rlk")
    eph = [rlk_proto.gen_ephemeral(g) for g in agens]
    agg1 = aggregate(rlk_proto, [
        rlk_proto.gen_share_round1(g, s, e, crps)
        for g, s, e in zip(agens, tsks, eph)])
    agg2 = aggregate(rlk_proto, [
        rlk_proto.gen_share_round2(g, s, e, agg1)
        for g, s, e in zip(agens, tsks, eph)])
    rlk = rlk_proto.finalize(agg1, agg2)

    # --- use the keys --------------------------------------------------------
    enc = bgv.Encoder(params)
    m = (np.arange(params.n) * 7) % params.t
    ct = rlwe.Encryptor(params, cpk).encrypt(agens[0], enc.encode(m))
    ev = bgv.Evaluator(params, rlwe.EvaluationKeySet(relinearization_key=rlk))
    ct2 = ev.rescale(ev.mul_relin(ct, ct))

    # collective decryption by the same t parties (key switch to sk'=0)
    cks = mp.KeySwitchProtocol(params)
    dagg = aggregate(cks, [
        cks.gen_share(g, s, None, ct2) for g, s in zip(agens, tsks)])
    plain = cks.key_switch(ct2, dagg)
    zero_sk = rlwe.SecretKey(params.ring_qp.zero())
    got = enc.decode(
        rlwe.Decryptor(params, zero_sk).decrypt(plain)) % params.t
    want = (m * m) % params.t
    ok = np.array_equal(got, want)
    print(f"{t}-out-of-{n_parties} threshold EVK gen + eval + decrypt: "
          f"{'OK' if ok else 'MISMATCH'}")
    assert ok


if __name__ == "__main__":
    main()
