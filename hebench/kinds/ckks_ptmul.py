"""Request kind ``ckks_ptmul``: each request is a batch of top-level
ciphertexts, each multiplied by one of a set of plaintext weights encoded
at set-up, then rescaled once: plaintext-weight products, which switch no
key.

Traffic keys: ``batch`` (ciphertexts a request; a multiple of
``weights``), ``weights`` (plaintexts; request i gives ciphertext c the
weight (c // (batch / weights) + i) mod weights), ``sample_requests``,
``sample_upto`` and ``sample_ct`` (which requests besides the first and
the last, and how many ciphertexts of each, the check decrypts).
"""

from __future__ import annotations

import torch

from hebench.kinds import common
from hebench.reference import ckks as ref


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, trace):
        from lattigo_tpu_torch import rlwe
        from lattigo_tpu_torch.schemes import ckks

        self.trace = trace
        params = common.ckks_params(cfg, device)
        self.params = params
        slots = params.max_slots
        b, nw = traffic["batch"], traffic["weights"]
        if b % nw:
            raise ValueError("batch must be a multiple of weights")
        self.batch, self.nw, self.group = b, nw, b // nw
        self.ct_per_request = b
        r = common.rng(seed, 2)
        self.msgs = common.uniform_slots(r, 1.0, (b, slots))
        self.w = common.uniform_slots(r, 1.0, (nw, slots))

        on_card = params.device.type == "cuda"
        before = torch.cuda.memory_allocated() if on_card else 0
        _, sk, self.sk_coeffs = common.secret_key(params, cfg, seed)
        if on_card:
            torch.cuda.synchronize()
        self.key_mem_bytes = (torch.cuda.memory_allocated() - before) if on_card else None
        self.ev = ckks.Evaluator(params)
        encoder = ckks.Encoder(params)
        self.pts = encoder.encode(self.w)
        ct = rlwe.Encryptor(params, sk).encrypt(
            common.torch_gen(seed, 1, params.device), encoder.encode(self.msgs),
            batch=(b,))
        self.ct = ct.replace(value=ct.value.reshape((nw, self.group) + ct.value.shape[1:]))
        ar = torch.arange(nw, device=params.device)
        self.perm = [(ar + i) % nw for i in range(nw)]
        self.held = common.Held(seed, traffic, b)

    def request(self, i: int):
        pt = self.pts.replace(value=self.pts.value[self.perm[i % self.nw]][:, None])
        with self.trace.span("mul"):
            x = self.ev.mul(self.ct, pt)
        with self.trace.span("rescale"):
            return self.ev.rescale(x)

    def keep(self, i: int, out) -> None:
        self.held.keep(i, out, out.value.reshape((self.batch,) + out.value.shape[2:]))

    def samples(self):
        def want(i, c):
            return ref.want_ptmul(self.msgs[c], self.w[(c // self.group + i) % self.nw])
        return self.held.samples(want, self.params.max_level - 1)
