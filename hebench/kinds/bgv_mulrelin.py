"""Request kind ``bgv_mulrelin``: each request is a batch of BGV
ciphertexts at the top level through rescale(mul_relin(a, b)), the
integer scheme's multiplication step: tensoring by T, relinearization
(key switching) and the division by the last prime.

Traffic keys: ``batch`` (products a request), ``pool`` (messages
encrypted at set-up, slot values uniform in [0, T)), ``b_offset``
(request i multiplies pool slot (i + j) by slot (i + b_offset + j),
j < batch, both mod pool; 0 squares each ciphertext, b is a),
``sample_requests``, ``sample_upto`` and ``sample_ct`` (which requests
besides the first and the last, and how many ciphertexts of each, the
check decrypts: :class:`~hebench.kinds.common.Held`).
"""

from __future__ import annotations

import torch

from hebench.kinds import common
from hebench.reference import bgv as ref


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, trace):
        from lattigo_tpu_torch import rlwe
        from lattigo_tpu_torch.schemes import bgv

        self.trace = trace
        params = common.bgv_params(cfg, device)
        self.params = params
        b, pool, off = traffic["batch"], traffic["pool"], traffic["b_offset"]
        self.batch, self.pool, self.b_offset = b, pool, off
        self.ct_per_request = b
        self.msgs = common.rng(seed, 2).integers(0, params.t, (pool, params.n))

        on_card = params.device.type == "cuda"
        before = torch.cuda.memory_allocated() if on_card else 0
        kgen, sk, self.sk_coeffs = common.secret_key(params, cfg, seed)
        rlk = kgen.gen_relinearization_key(common.torch_gen(seed, 0, params.device), sk)
        if on_card:
            torch.cuda.synchronize()
        self.key_mem_bytes = (torch.cuda.memory_allocated() - before) if on_card else None
        self.ev = bgv.Evaluator(params, rlwe.EvaluationKeySet(rlk))
        self.pool_ct = rlwe.Encryptor(params, sk).encrypt(
            common.torch_gen(seed, 1, params.device), bgv.Encoder(params).encode(self.msgs),
            batch=(pool,))
        ar = torch.arange(b, device=params.device)
        self.idx = [((i + ar) % pool, (i + off + ar) % pool) for i in range(pool)]
        self.held = common.Held(seed, traffic, b)

    def request(self, i: int):
        ia, ib = self.idx[i % self.pool]
        v = self.pool_ct.value
        ca = self.pool_ct.replace(value=v[ia])
        cb = ca if self.b_offset == 0 else self.pool_ct.replace(value=v[ib])
        with self.trace.span("mul_relin"):
            x = self.ev.mul_relin(ca, cb)
        with self.trace.span("rescale"):
            return self.ev.rescale(x)

    def keep(self, i: int, out) -> None:
        self.held.keep(i, out, out.value)

    def samples(self):
        t = self.params.t

        def want(i, j):
            a = self.msgs[(i + j) % self.pool]
            b = self.msgs[(i + self.b_offset + j) % self.pool]
            return ref.want_mul(a, b, t)
        return self.held.samples(want, self.params.max_level - 1)
