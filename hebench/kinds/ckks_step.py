"""Request kind ``ckks_step``: each request is a batch of ciphertexts at the
top level through rescale(lintrans(rescale(mul_relin(a, b)))), the
multiplication then linear layer of encrypted inference.

Traffic keys: ``batch`` (ciphertexts a request, each of a and b),
``pool`` (messages encrypted at set-up; request i takes a from pool slots
i.. and b from i+batch..), ``diagonals`` and ``n1`` (the transformation's
nonzero diagonals and its baby steps), ``galois_keys`` (keys it needs),
``sample_requests``, ``sample_upto`` and ``sample_ct`` (which requests
besides the first and the last, and how many ciphertexts of each, the
check decrypts: :class:`~hebench.kinds.common.Held`).
"""

from __future__ import annotations

import torch

from hebench.kinds import common
from hebench.reference import ckks as ref


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, trace):
        from lattigo_tpu_torch import rlwe
        from lattigo_tpu_torch.circuits import lintrans
        from lattigo_tpu_torch.schemes import ckks

        self.trace = trace
        params = common.ckks_params(cfg, device)
        self.params = params
        slots = params.max_slots
        b, pool = traffic["batch"], traffic["pool"]
        self.batch, self.pool = b, pool
        self.ct_per_request = b
        r = common.rng(seed, 2)
        self.msgs = common.uniform_slots(r, 1.0, (pool, slots))
        d = traffic["diagonals"]
        self.diags = {k: common.uniform_slots(r, 1.0 / d, slots) for k in range(d)}
        level = params.max_level - 1
        encoder = ckks.Encoder(params)
        lt = lintrans.encode_linear_transformation(
            params, self.diags,
            lintrans.ckks_diag_encoder(params, encoder, params.q_moduli[level]),
            level_q=level, scale=params.q_moduli[level], slots=slots)
        els = lt.galois_elements(params)
        if lt.n1 != traffic["n1"] or len(els) != traffic["galois_keys"]:
            raise RuntimeError(f"transformation with n1 {lt.n1} and {len(els)} keys")
        self.lt = lt

        on_card = params.device.type == "cuda"
        before = torch.cuda.memory_allocated() if on_card else 0
        kgen, sk, self.sk_coeffs = common.secret_key(params, cfg, seed)
        gen = common.torch_gen(seed, 0, params.device)
        rlk = kgen.gen_relinearization_key(gen, sk)
        gks = kgen.gen_galois_keys(gen, els, sk, levels={g: level for g in els})
        if on_card:
            torch.cuda.synchronize()
        self.key_mem_bytes = (torch.cuda.memory_allocated() - before) if on_card else None
        self.ev = ckks.Evaluator(params, rlwe.EvaluationKeySet(rlk, gks))
        self.lte = lintrans.LinTransEvaluator(self.ev)
        self.pool_ct = rlwe.Encryptor(params, sk).encrypt(
            common.torch_gen(seed, 1, params.device), encoder.encode(self.msgs),
            batch=(pool,))
        ar = torch.arange(b, device=params.device)
        self.idx = [((i + ar) % pool, (i + b + ar) % pool) for i in range(pool)]
        self.held = common.Held(seed, traffic, b)

    def request(self, i: int):
        ia, ib = self.idx[i % self.pool]
        v = self.pool_ct.value
        ca = self.pool_ct.replace(value=v[ia])
        cb = self.pool_ct.replace(value=v[ib])
        ev, t = self.ev, self.trace
        with t.span("mul_relin"):
            x = ev.mul_relin(ca, cb)
        with t.span("rescale"):
            x = ev.rescale(x)
        with t.span("lintrans"):
            x = self.lte.evaluate(x, self.lt)
        with t.span("rescale"):
            return ev.rescale(x)

    def keep(self, i: int, out) -> None:
        self.held.keep(i, out, out.value)

    def samples(self):
        def want(i, j):
            a = self.msgs[(i + j) % self.pool]
            b = self.msgs[(i + self.batch + j) % self.pool]
            return ref.want_step(a, b, self.diags)
        return self.held.samples(want, self.params.max_level - 2)
