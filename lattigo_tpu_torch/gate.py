"""Correctness gate on the card: the counterpart of the JAX package's
``tpu_gate.py``, with its four gates and their names.

The CPU tests hold the port against the JAX package through each kernel's
plain version, so they cannot see a kernel that builds or launches wrong,
or that parts from its plain version at a shape only the card runs. The
gate runs what only means something there:

1. :func:`gate_kat`: known-answer NTT vectors, bit-exact, forward and
   back: vectors of Lattigo's sizes (N = 16 … 512, two 60-bit primes)
   whose answers come from the definition of the negacyclic transform,
   evaluated with Python integers: NTT(a)_j = a(ψ^{2·brev(j)+1}).
2. :func:`gate_engines`: every engine a ring can take, against radix-2:
   the four-step kernel (``csrc/ntt_mxu.cu``) and the u32 kernel
   (``csrc/ntt_pallas.cu``), forward and inverse, lazy and not, each also
   bit-equal to its plain torch version on the card; the u64 four-step
   engine on 50-bit, mixed 25 / 50 / 61-bit and (full) 60-bit chains
   (``mxu64-plain``; on the card at logN 15-16 the u64 kernel
   ``csrc/ntt_u64.cu``, also against its plain version); and the ModUp
   digit-matmul contraction against the raw multiply-accumulate. On the
   CPU every engine is its plain version.
3. :func:`gate_bootstrap`: one bootstrap at logN 8 with ≥ 8 bits.
4. :func:`gate_preset`: the published ``N15QP768_H192_H32`` recipe at
   logN 10, worst ≥ 15.0 / mean ≥ 17.0 bits (``--full``: at logN 15, worst
   ≥ 12.0 / mean ≥ 14.5), the thresholds of ``tpu_gate.py``.

    python3 gpu_gate.py [--device cpu] [--full]

runs on the card unless ``--device cpu`` is given, and raises without one.
A failing gate raises: nothing is caught, and the process exits non-zero
with the failure's traceback. When every gate passes it prints one JSON
line of results and exits 0.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from lattigo_tpu_torch.device import resolve_device

GATES = ("gate_kat", "gate_engines", "gate_bootstrap", "gate_preset")
KAT_LOG_NS = range(4, 10)          # N = 16 … 512, as Lattigo's vectors
KAT_PRIME_BITS = 60


class GateFailure(AssertionError):
    """A gate's check did not hold."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise GateFailure(msg)


# -- known answers ------------------------------------------------------------

def negacyclic_ntt_definition(poly, moduli, n: int) -> np.ndarray:
    """NTT(a)_j = Σ_k a_k ψ^{(2·brev(j)+1)·k} mod q for each limb, in Python
    integers: the transform's definition, independent of every engine."""
    from lattigo_tpu_torch.ring.ntt import bit_reverse_array
    from lattigo_tpu_torch.utils.primes import primitive_nth_root

    brev = bit_reverse_array(n.bit_length() - 1).astype(np.int64)
    expo = ((2 * brev[:, None] + 1) * np.arange(n)[None, :]) % (2 * n)
    out = np.zeros((len(moduli), n), dtype=np.uint64)
    for i, q in enumerate(moduli):
        psi = primitive_nth_root(q, 2 * n)
        powers = np.array([pow(psi, e, q) for e in range(2 * n)], dtype=object)
        a = np.array([int(v) for v in poly[i]], dtype=object)
        out[i] = [int(v) % q for v in powers[expo].dot(a)]
    return out


def definition_vectors(seed: int = 0) -> list[tuple]:
    """Vectors of Lattigo's sizes (N = 16 … 512, two 60-bit primes each),
    seeded inputs, answers from :func:`negacyclic_ntt_definition`."""
    out = []
    for log_n in KAT_LOG_NS:
        n = 1 << log_n
        qis = _chain_primes(log_n, [KAT_PRIME_BITS] * 2)
        rng = np.random.default_rng(seed + log_n)
        poly = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in qis])
        out.append((n, qis, poly, negacyclic_ntt_definition(poly, qis, n)))
    return out


def gate_kat(device) -> dict:
    """Each known-answer vector bit-exact through the ring's NTT, and back."""
    from lattigo_tpu_torch import interop
    from lattigo_tpu_torch.ring.ring import Ring

    vectors = definition_vectors()
    _check(len(vectors) > 0, "no known-answer vectors")
    engines = []
    for n, qis, poly, poly_ntt in vectors:
        ring = Ring(n, qis, device=device)
        x = interop.to_torch(poly, device)
        got = ring.ntt(x)
        _check(np.array_equal(interop.to_numpy(got), poly_ntt), f"KAT N={n}: NTT differs")
        _check(torch.equal(ring.intt(got), x), f"KAT N={n}: INTT differs")
        engines.append(ring.ntt_engine)
    return dict(vectors=len(vectors), n=[v[0] for v in vectors],
                engines=sorted(set(engines)))


# -- engines ------------------------------------------------------------------

def engine_chains(full: bool = False) -> list[tuple[str, int, list[int]]]:
    """(engine the ring must take, logN, primes below 2^b): the four-step
    kernel at logN 13-16 on 28-bit primes (its fused launch at 13-14, its
    thread-block clusters at 15-16); the u32 kernel at logN 10 and 15 on
    30-bit primes; the u64 four-step engine on 50-bit primes at logN 13 and
    16 and a mixed 25 / 50 / 61-bit chain at logN 15 (``--full``: 60-bit at
    logN 14 and 16 too). ``tpu_gate.py`` runs its engines on these prime
    classes."""
    chains = [("mxu", 13, [28, 28]), ("mxu", 14, [28, 28]),
              ("mxu", 15, [28, 28]), ("mxu", 16, [28, 28]),
              ("u32", 10, [30, 30]), ("u32", 15, [30, 30]),
              ("mxu64", 13, [50, 50]), ("mxu64", 16, [50, 50]),
              ("mxu64", 15, [25, 50, 61])]
    if full:
        chains += [("mxu64", 14, [60, 60]), ("mxu64", 16, [60, 60])]
    return chains


def _chain_primes(log_n: int, bits: list[int]) -> list[int]:
    """NTT-friendly primes at 2N, each the next below 2^b for b in ``bits``."""
    from lattigo_tpu_torch.utils.primes import NTTFriendlyPrimesGenerator

    gens = {}
    for b in bits:
        gens.setdefault(b, NTTFriendlyPrimesGenerator(b, 2 << log_n))
    return [gens[b].next_downstream_prime() for b in bits]


def _radix2(ring, x, inverse: bool, lazy: bool):
    from lattigo_tpu_torch.ring import ntt as ntt_mod

    if inverse:
        return ntt_mod.intt(x, ring.iroots, ring.ninv, ring.q, ring.qinv, ring.log_n,
                            lazy=lazy, small=ring.small)
    return ntt_mod.ntt(x, ring.roots, ring.q, ring.qinv, ring.log_n, lazy=lazy,
                       small=ring.small)


def _plain_twin(ring):
    """The plain torch version of the ring's kernel, or None."""
    from lattigo_tpu_torch.ring import ntt_mxu, ntt_pallas, ntt_u64

    if ring._u64 is not None:
        return lambda x, inverse, lazy: ntt_u64.u64_plain(ring._u64, x, 0, inverse, lazy)
    if ring._mxu is not None:
        return lambda x, inverse, lazy: ntt_mxu.four_step_plain(ring._mxu, x, 0, inverse, lazy)
    if ring._u32 is not None:
        return lambda x, inverse, lazy: ntt_pallas.u32_plain(ring._u32, x, 0, inverse, lazy)
    return None


def check_engine(ring, x) -> int:
    """The ring's NTT and INTT, lazy and not, against radix-2 (equal, lazy
    ones mod q) and, where a kernel ran, bit-equal to its plain version;
    INTT(NTT(x)) = x. Returns the number of comparisons made."""
    q = ring.q
    twin = _plain_twin(ring) if ring.device.type == "cuda" else None
    made = 0
    for inverse in (False, True):
        fn = ring.intt if inverse else ring.ntt
        for lazy in (False, True):
            got = fn(x, lazy=lazy)
            want = _radix2(ring, x, inverse, lazy)
            tag = f"{ring.ntt_engine} logN={ring.log_n} inverse={inverse} lazy={lazy}"
            if lazy:
                _check(torch.equal(got % q, want % q), f"{tag}: != radix-2 mod q")
            else:
                _check(torch.equal(got, want), f"{tag}: != radix-2")
            made += 1
            if twin is not None:
                _check(torch.equal(got, twin(x, inverse, lazy)),
                       f"{tag}: kernel != its plain version")
                made += 1
    _check(torch.equal(ring.intt(ring.ntt(x)), x),
           f"{ring.ntt_engine} logN={ring.log_n}: INTT(NTT(x)) != x")
    return made


def check_mod_up(device, log_n: int, seed: int = 0) -> str:
    """``bgv_tpu_params(log_n, 438)``'s Q -> P conversion at full level
    (2 polynomials): the digit-matmul contraction equal to the raw MAC."""
    import copy

    from lattigo_tpu_torch.presets import bgv_tpu_params
    from lattigo_tpu_torch.ring import basis_extension
    from lattigo_tpu_torch.schemes import bgv

    params = bgv.Parameters(bgv_tpu_params(log_n, 438), device=device)
    src, dst, rp = params.q_moduli, params.p_moduli, params.ring_p
    consts = basis_extension.ModUpConstants(src, dst, device)
    _check(consts.mxu, "ModUp Q -> P is not on the digit-matmul route")
    raw = copy.copy(consts)
    raw.mxu = False
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.stack([torch.randint(0, q, (2, params.n), generator=gen, device=device,
                                   dtype=torch.int64) for q in src], dim=-2)
    args = (rp.q, rp.qinv, rp.bred_hi)
    got = basis_extension.mod_up(x, consts, *args)
    _check(torch.equal(got, basis_extension.mod_up(x, raw, *args)),
           f"ModUp logN={log_n}: digit matmul != raw MAC")
    return f"{tuple(x.shape)} -> {tuple(got.shape)}"


def gate_engines(device, full: bool = False, chains=None, mod_up_log_n: int = 14,
                 seed: int = 0) -> dict:
    """Every chain of :func:`engine_chains` (or ``chains``) on the engine it
    must take, through :func:`check_engine` on 2 polynomials of uniform
    residues; then :func:`check_mod_up`."""
    from lattigo_tpu_torch.ring.ring import Ring

    device = torch.device(device)
    results = []
    for engine, log_n, bits in (chains or engine_chains(full)):
        ring = Ring(1 << log_n, _chain_primes(log_n, bits), device=device)
        _check(ring._engine == engine,
               f"logN={log_n} {bits}-bit: ring takes {ring._engine}, not {engine}")
        gen = torch.Generator(device=device).manual_seed(seed + log_n)
        x = torch.stack([torch.randint(0, q, (2, ring.n), generator=gen, device=device,
                                       dtype=torch.int64) for q in ring.moduli], dim=-2)
        made = check_engine(ring, x)
        results.append(dict(engine=ring.ntt_engine, log_n=log_n, bits=bits, checks=made))
    return dict(chains=results, mod_up=check_mod_up(device, mod_up_log_n, seed))


# -- bootstraps ---------------------------------------------------------------

def gate_bootstrap(device, min_bits: float = 8.0, seed: int = 0) -> dict:
    """One bootstrap at logN 8 (Q 55 + 45, P 60 + 60, H = 32, one C2S and
    one S2C level each side, no encapsulation) of 2^7 uniform complex slots,
    worst ≥ ``min_bits``."""
    from lattigo_tpu_torch import rlwe
    from lattigo_tpu_torch.circuits import bootstrapping as bts
    from lattigo_tpu_torch.circuits import bootstrapping_presets as bp
    from lattigo_tpu_torch.ring.sampling import Ternary
    from lattigo_tpu_torch.schemes import ckks

    residual = ckks.ParametersLiteral(
        log_n=8, log_q=(55, 45), log_p=(60, 60), log_default_scale=45,
        xs=Ternary(hamming_weight=32))
    lit = bp.BootstrappingLiteral(
        c2s_log_scales=[[56], [56]], s2c_log_scales=[[39], [39]],
        ephemeral_secret_weight=None)
    full, btp = bp.build_bootstrapping_parameters(residual, lit)
    params = ckks.Parameters(full, device)
    g_sk, g_rlk, g_gk, g_ct = (torch.Generator(device=params.device).manual_seed(seed * 4 + i)
                               for i in range(4))
    kgen = rlwe.KeyGenerator(params)
    sk = kgen.gen_secret_key(g_sk)
    rlk = kgen.gen_relinearization_key(g_rlk, sk)
    enc = ckks.Encoder(params)
    b = bts.BootstrappingEvaluator(params, ckks.Evaluator(
        params, rlwe.EvaluationKeySet(relinearization_key=rlk)), enc, btp)
    gks = kgen.gen_galois_keys(g_gk, b.galois_elements(), sk)
    b.with_evaluator(ckks.Evaluator(params, rlwe.EvaluationKeySet(
        relinearization_key=rlk, galois_keys=gks)))
    rng = np.random.default_rng(1)
    v = (rng.uniform(-1, 1, params.max_slots)
         + 1j * rng.uniform(-1, 1, params.max_slots))
    ct = rlwe.Encryptor(params, sk).encrypt(g_ct, enc.encode(v)).at_level(0)
    got = enc.decode(rlwe.Decryptor(params, sk).decrypt(b.bootstrap(ct)))
    worst, mean = bp.precision_bits(got, v)
    _check(worst >= min_bits, f"bootstrap logN=8 precision {worst:.2f} < {min_bits} bits")
    return dict(log_n=8, worst_bits=worst, mean_bits=mean, engine=params.ring_q.ntt_engine)


def gate_preset(device, log_n: int | None = 10, min_worst: float = 15.0,
                min_avg: float = 17.0) -> dict:
    """The published ``N15QP768_H192_H32`` recipe at ``log_n`` (None: its
    full logN 15): worst ≥ ``min_worst``, mean ≥ ``min_avg`` bits."""
    from lattigo_tpu_torch.circuits import bootstrapping_presets as bp

    worst, avg = bp.run_recipe(bp.N15QP768_H192_H32, log_n=log_n, device=device)
    _check(worst >= min_worst, f"preset worst {worst:.2f} < {min_worst} bits")
    _check(avg >= min_avg, f"preset mean {avg:.2f} < {min_avg} bits")
    return dict(preset="N15QP768_H192_H32", log_n=log_n or 15, worst_bits=worst,
                mean_bits=avg, floor=[min_worst, min_avg])


# -- entry --------------------------------------------------------------------

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(device=None, full: bool = False) -> dict:
    """Run the four gates in order on ``device`` (CUDA unless named); the
    first failure raises. Returns each gate's result with its seconds and
    the kernels' launches over the run."""
    from lattigo_tpu_torch.ring import ntt_mxu, ntt_pallas, ntt_u64

    device = resolve_device(device)
    gates = {
        "gate_kat": lambda: gate_kat(device),
        "gate_engines": lambda: gate_engines(device, full),
        "gate_bootstrap": lambda: gate_bootstrap(device),
        "gate_preset": (lambda: gate_preset(device, None, 12.0, 14.5)) if full
        else (lambda: gate_preset(device)),
    }
    for kernel in (ntt_mxu, ntt_pallas, ntt_u64):
        kernel.reset_launches()
    results = {}
    for name in GATES:
        t0 = time.perf_counter()
        results[name] = gates[name]()
        _sync(device)
        results[name]["s"] = time.perf_counter() - t0
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return dict(gate="PASS", device=dict(platform=device.type, kind=kind), full=full,
                gates=results, launches=dict(ntt_mxu=dict(ntt_mxu.LAUNCHES),
                                             ntt_pallas=dict(ntt_pallas.LAUNCHES),
                                             ntt_u64=dict(ntt_u64.LAUNCHES)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run there)")
    ap.add_argument("--full", action="store_true",
                    help="more prime classes, and the preset at its full logN 15")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.device, a.full)), flush=True)
    return 0
