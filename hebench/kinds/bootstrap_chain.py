"""Request kind ``bootstrap_chain``: each request bootstraps a batch of
full-slot ciphertexts; each call's input is the set-up's ciphertext plus a
zero made from the previous call's output, so that no call starts before
the one before it has ended (the chain of ``bootstrap_driver.py``).

Traffic keys: ``batch`` (ciphertexts a call), ``sample_requests`` and
``sample_upto`` (which calls besides the first and the last the check
decrypts; all ciphertexts of each).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from hebench.kinds import common


def literals(cfg: dict):
    """(residual CKKS literal, bootstrapping literal) of a configuration."""
    from lattigo_tpu_torch.circuits import bootstrapping_presets as bp
    from lattigo_tpu_torch.ring.sampling import Ternary
    from lattigo_tpu_torch.schemes import ckks

    res = cfg["residual"]
    residual = ckks.ParametersLiteral(
        log_n=cfg["log_n"], log_q=tuple(res["log_q"]), log_p=tuple(res["log_p"]),
        xs=Ternary(hamming_weight=cfg["secret"]["hamming_weight"]),
        log_default_scale=cfg["log_default_scale"])
    return residual, bp.BootstrappingLiteral(**cfg["bootstrapping"])


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, trace):
        from lattigo_tpu_torch import rlwe
        from lattigo_tpu_torch.circuits import bootstrapping_presets as bp
        from lattigo_tpu_torch.schemes import ckks

        self.trace = trace
        residual, lit = literals(cfg)
        full, btp_params = bp.build_bootstrapping_parameters(residual, lit)
        params = ckks.Parameters(replace(full, q=tuple(cfg["q"]), p=tuple(cfg["p"]),
                                         log_q=None, log_p=None), device)
        common.check_moduli(params, cfg)
        self.params = params
        self.batch = traffic["batch"]
        self.ct_per_request = self.batch
        self.out_level = len(cfg["residual"]["log_q"]) - 1

        on_card = params.device.type == "cuda"
        before = torch.cuda.memory_allocated() if on_card else 0
        kgen, sk, self.sk_coeffs = common.secret_key(params, cfg, seed)
        rlk = kgen.gen_relinearization_key(common.torch_gen(seed, 0, params.device), sk)
        enc = ckks.Encoder(params)
        b = bp.BootstrappingEvaluator(params, ckks.Evaluator(
            params, rlwe.EvaluationKeySet(relinearization_key=rlk)), enc, btp_params)
        gks = kgen.gen_galois_keys(common.torch_gen(seed, 2, params.device),
                                   list(b.galois_elements()), sk,
                                   levels=dict(b.galois_element_levels()))
        b.with_evaluator(ckks.Evaluator(params, rlwe.EvaluationKeySet(
            relinearization_key=rlk, galois_keys=gks)))
        self.keys = b.gen_encapsulation_keys(common.torch_gen(seed, 3, params.device), sk)
        if on_card:
            torch.cuda.synchronize()
        self.key_mem_bytes = (torch.cuda.memory_allocated() - before) if on_card else None
        self.btp = b

        self.msgs = common.uniform_slots(common.rng(seed, 2), 1.0,
                                         (self.batch, params.max_slots))
        self.ct = rlwe.Encryptor(params, sk).encrypt(
            common.torch_gen(seed, 1, params.device), enc.encode(self.msgs),
            batch=(self.batch,)).at_level(b.minimum_input_level)
        self.held = common.Held(seed, traffic, self.batch)
        self.prev = None

    def request(self, i: int):
        cur = self.ct
        if self.prev is not None:
            cur = cur.replace(value=cur.value + self.prev.value.reshape(-1)[:1] * 0)
        with self.trace.stages() as on_stage:
            self.prev = self.btp.bootstrap(cur, self.keys, on_stage=on_stage)
        return self.prev

    def keep(self, i: int, out) -> None:
        self.held.keep(i, out, out.value)

    def samples(self):
        return self.held.samples(lambda i, j: self.msgs[j], self.out_level)
