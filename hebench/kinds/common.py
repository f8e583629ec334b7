"""What the request kinds share: the seed's streams, the secret key's
coefficients, and the program's CKKS parameters built from a
configuration."""

from __future__ import annotations

import numpy as np
import torch


def rng(seed: int, *tag: int) -> np.random.Generator:
    """A NumPy stream of ``seed`` for one use, named by ``tag``."""
    return np.random.default_rng(np.random.SeedSequence([seed, *tag]))


def torch_gen(seed: int, tag: int, device) -> torch.Generator:
    """A torch.Generator on ``device`` seeded from ``seed`` for one use."""
    s = int(np.random.SeedSequence([seed, 1000 + tag]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s >> 1)


def secret_coeffs(cfg: dict, seed: int) -> np.ndarray:
    """The secret key's signed coefficients, drawn from the seed as the
    configuration's distribution says: a fixed Hamming weight, or each
    coefficient 0 with probability ``p_zero`` and ±1 otherwise."""
    n = 1 << cfg["log_n"]
    sec = cfg["secret"]
    r = rng(seed, 1)
    s = np.zeros(n, dtype=np.int64)
    if sec.get("hamming_weight") is not None:
        h = sec["hamming_weight"]
        pos = r.choice(n, size=h, replace=False)
        s[pos] = r.integers(0, 2, size=h) * 2 - 1
    else:
        nz = r.random(n) >= sec["p_zero"]
        s[nz] = (r.integers(0, 2, size=n) * 2 - 1)[nz]
    return s


def uniform_slots(r: np.random.Generator, bound: float, shape) -> np.ndarray:
    """Complex slots with real and imaginary parts uniform in [-bound, bound)."""
    return r.uniform(-bound, bound, shape) + 1j * r.uniform(-bound, bound, shape)


def check_moduli(params, cfg: dict) -> None:
    """The program runs the configuration's primes, or the run stops."""
    if list(params.q_moduli) != list(cfg["q"]) or list(params.p_moduli) != list(cfg["p"]):
        raise RuntimeError("the program's moduli differ from the configuration's")


def ckks_params(cfg: dict, device):
    """The program's CKKS parameters at the configuration's primes."""
    from lattigo_tpu_torch.ring.sampling import Ternary
    from lattigo_tpu_torch.schemes import ckks

    sec = cfg["secret"]
    xs = (Ternary(hamming_weight=sec["hamming_weight"])
          if sec.get("hamming_weight") is not None else Ternary(p=sec["p_zero"]))
    lit = ckks.ParametersLiteral(log_n=cfg["log_n"], q=tuple(cfg["q"]), p=tuple(cfg["p"]),
                                 xs=xs, log_default_scale=cfg["log_default_scale"])
    params = ckks.Parameters(lit, device=device)
    check_moduli(params, cfg)
    return params


def secret_key(params, cfg: dict, seed: int):
    """(the program's key generator, its SecretKey of the seed's
    coefficients, the coefficients)."""
    from lattigo_tpu_torch import rlwe

    coeffs = secret_coeffs(cfg, seed)
    kgen = rlwe.KeyGenerator(params)
    return kgen, kgen.secret_key_from_signed(torch.from_numpy(coeffs).to(params.device)), coeffs


def host_value(ct) -> np.ndarray:
    """A ciphertext's residues on the host as uint64 [..., degree+1, L, N]."""
    return ct.value.detach().cpu().numpy().view(np.uint64)


class Held:
    """The outputs the check reads: those of request 0, of
    ``sample_requests`` more drawn from the seed below ``sample_upto``, and
    of the last request; of each, ``sample_ct`` ciphertexts drawn from the
    seed (every one where the traffic names no count)."""

    def __init__(self, seed: int, traffic: dict, batch: int):
        self.rng = rng(seed, 3)
        self.at = {0} | set(self.rng.integers(1, traffic["sample_upto"],
                                              traffic["sample_requests"]).tolist())
        self.batch, self.per = batch, traffic.get("sample_ct", batch)
        self.kept: dict[int, tuple] = {}
        self.last = None

    def keep(self, i: int, out, rows) -> None:
        """Hold request i's output ``out``; ``rows`` is its value with the
        batch on one leading axis."""
        sel = sorted(self.rng.choice(self.batch, self.per, replace=False).tolist())
        held = (sel, out.replace(value=rows[sel].clone()))
        if i in self.at:
            self.kept[i] = held
        self.last = (i, held)

    def samples(self, want, level: int):
        """Each held ciphertext as the check reads it: residues on the
        host, flags, scale, ``want(i, j)`` (the answer due to ciphertext j
        of request i) and the level due."""
        held = dict(self.kept)
        if self.last is not None:
            held[self.last[0]] = self.last[1]
        for i, (sel, out) in sorted(held.items()):
            vals = host_value(out)
            for row, j in enumerate(sel):
                yield dict(value=vals[row], is_ntt=out.is_ntt,
                           is_montgomery=out.is_montgomery, scale=out.scale,
                           want=want(i, j), level=level)
