#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero before the result):

1. build every CUDA kernel of the paths from ``lattigo_tpu_torch/csrc``
   (one ``nvcc`` per source, started together);
2. hold each kernel bit for bit against its plain torch version on the card,
   lazy and not, through a non-zero limb offset too, and NTT then INTT as
   the identity; time kernel and plain version with CUDA events:
   the four-step kernel (``ntt_mxu.cu``) at 4 polynomials x 15 limbs x
   16384 on the BGV chain, with the blocks per (limb, polynomial) it picks
   there (``split``), and at logN 12 and 13 on 2 x 3 x N; the u32 kernel
   (``ntt_pallas.cu``) at the blind rotation's own shape, 2 x 1 x 1024,
   and at 4 x 15 x 16384 on 15 alternating 29-bit primes; at 2 x 1 x 1024
   also the u32 kernel's host time per call (wall clock over 1000
   back-to-back calls ending in one synchronize);
3. serve one batch of 4 requests on BGV ``bgv_tpu_params(14, 438)``
   (N = 16384, 13 + 2 primes < 2^29, T = 65537): encode + encrypt,
   ``rescale(mul_relin(a, b))``, decrypt + decode, every slot checked
   against numpy's a*b mod T; the kernels' launch counts are zeroed just
   before and read just after, and every distinct kernel call of that run
   is held against the plain version on its own input (each printed with
   its split); then the step is timed after a warm-up and profiled once,
   which gives the four-step kernels' device time per launch;
4. LMKCDEY blind rotation at Lattigo's blind-rotation parameters (BR ring
   logN 10, Q = 0x7fff801, P = 536881153; LWE ring logN 9, Q = 0x3001):
   key generation (512 RGSW keys, 11 Galois keys), then one LWE ciphertext
   of 16 values x = -1 + 2i/16 blind-rotated through the sign test
   polynomial slot by slot, decrypted, every slot with x != 0 checked
   against sign(x); launch counts zeroed before and read after, every
   distinct u32 kernel call held against the plain version; one LUT
   profiled, which gives the u32 kernels' device time per launch;
5. one batch of 4 requests on CKKS ``ckks_tpu_params(14, 438)`` (N =
   16384, 13 + 2 primes < 2^29, scale 2^28): the Galois keys of a linear
   transformation of 16 diagonals scoped to level 11, encode + encrypt,
   ``rescale(evaluate(rescale(mul_relin(a, b)), lt))`` (the hoisted-BSGS
   evaluator: n1 = 4, 3 baby and 3 giant rotations), decrypt + decode,
   every slot held against numpy's M·(a∘b) at a precision floor set from
   the JAX package's result less a bit; launch counts zeroed before and
   read after, every distinct four-step call held against the plain
   version; the step timed and profiled, the peak device memory and the
   decode's host CRT of one polynomial printed;
6. the multiparty path on BGV ``bgv_tpu_params(14, 438)``: 4 parties,
   threshold 3, public points 1-4, active set {1, 2, 4}, each party with
   its own generator on the card. Secret keys Shamir-shared, aggregated and
   turned into additive shares by the active parties; their collective
   public key (one round), relinearization key (two rounds, ephemeral
   keys) and Galois key for rotate_columns(1), every CRP from a seed;
   4 a and 4 b encrypted under the collective key;
   ``rotate_columns(rescale(mul_relin(a, b)), 1)``; collective decryption
   (CKS to 0), a public-key switch to a receiver's key, a collective
   evaluation key to a fresh committee key applied and decrypted by the
   new committee, and a BGV refresh of one ciphertext back to the top
   level, each decoded and checked against numpy's roll of a*b mod T in
   every slot; then a CKKS refresh at ``ckks_tpu_params(14, 438)`` of a
   vector encrypted at level 1 (three fresh parties, 40-bit masks) to the
   top level, decrypted collectively and held at a precision floor set
   from the JAX package's result less a bit. Launch counts zeroed before
   and read after, every distinct four-step call held against the plain
   version; per protocol the ms of gen_share (per party), aggregate and
   finalize and its four-step launches; the CRPs' host ms; the step and
   the request timed; peak device memory; the collective relinearization
   key generation and the request profiled;
7. CKKS bootstrapping at the published preset ``N15QP768_H192_H32``, full
   logN 15 (2^14 complex slots, 15 Q + 2 P primes of 25-61 bits, an
   H = 192 secret, ModUp under an H = 32 ephemeral secret): every earlier
   phase's tensors freed and the peak memory counter reset; parameters
   from the preset builder; the secret, relinearization, 53 level-scoped
   Galois and two encapsulation keys, each from its own generator on the
   card, and the DFT matrices, each timed; one input of uniform complex
   slots from a numpy seed, encrypted and dropped to the minimum input
   level; one untimed warm-up bootstrap with its dispatched torch ops
   counted (and those inside the radix-2 NTT); then one bootstrap timed by
   stage (ScaleDown + encapsulation + ModUp, C2S, EvalMod on each half,
   S2C, each ending in a synchronize), equal to the warm-up's output,
   decrypted, decoded and held at a precision floor set from the JAX
   package's full-degree result less a bit; the rings' NTT engine
   (radix2-plain: no kernel of this repository runs here, and the kernels'
   launch counts over the bootstrap must be 0); the output level and
   scale; peak device memory; one EvalMod half profiled (device kernels,
   busy us, idle share, the top three kernel families);
8. the card's name and power limit as nvidia-smi gives them, the
   kernels' JSON line, and the result line.

Needs one CUDA card, ``nvcc`` and the repository beside this file; imports
nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEED = 1234
BATCH = 4
LOG_N, LOG_QP = 14, 438
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense int8 op/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# int32 ALU peak: 132 SMs x 64 int32 lanes x 1.98 GHz boost (the clock of
# the data sheet's 67 TFLOP/s fp32 = 132 x 128 lanes x 2 x 1.98 GHz)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit integer operations per u32 butterfly: two folds (compare + select
# each), four multiplies of the Montgomery product, its subtract-add, and
# the butterfly's add and subtract
U32_OPS_PER_BUTTERFLY = 12
BR_SLOTS = 16
CKKS_DIAGS = 16
# the CKKS step's precision floor (min, avg bits): the JAX package's
# get_precision_stats on the same step, parameters and inputs (seed 1234,
# on the CPU: min 13.07, avg 15.53 bits) less one bit
CKKS_MIN_BITS = (12.07, 14.53)
# the multiparty phase: parties, threshold, the active parties' points
MP_PARTIES, MP_THRESHOLD, MP_ACTIVE = 4, 3, (1, 2, 4)
# CKKS refresh: 12 bits of statistical security over scale 2^28 gives
# 40-bit masks and level 1 (get_minimum_level_for_refresh); its precision
# floor (min, avg bits): the JAX package's refresh on the same parameters,
# flow, input and CRP seeds (seed 1234, on the CPU: min 12.72, avg 16.04
# bits; tests/test_torch_sharing.py reference_refresh_precision) less one bit
MP_REFRESH_LAMBDA = 12
MP_REFRESH_MIN_BITS = (11.72, 15.04)
# the bootstrap phase: the published preset at full logN 15, and its
# precision floor (worst, mean bits): the JAX package's full-degree result
# at this preset, 13.8 worst / 16.0 mean bits (README.md), less one bit
BTP_PRESET = "N15QP768_H192_H32"
BTP_MIN_BITS = (12.8, 15.0)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def host_us_per_call(fn, reps: int = 1000) -> float:
    """Mean host microseconds of fn() over reps back-to-back calls that
    end in one synchronize, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over reps runs, after one
    warm-up run, timed with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from lattigo_tpu_torch import build
    t0 = time.perf_counter()
    logs = build.build(["ntt_mxu", "ntt_pallas"])
    secs = time.perf_counter() - t0
    regs = sorted({ln.split("Used ")[1].split(",")[0] for log in logs.values()
                   for ln in log.splitlines() if "Used " in ln})
    print(f"phase 1 build: ntt_mxu.cu and ntt_pallas.cu in {secs:.2f} s "
          f"(ptxas: {'; '.join(regs)})")


def four_step_bound(eng, shape) -> tuple[float, str]:
    """Least time for one four-step call on x int64[shape]: each input and
    output byte moved once (data + the used limbs' tables) against the int8
    multiply-adds of its two contractions, at the published peaks."""
    polys = 1
    for d in shape[:-1]:
        polys *= d
    limbs = shape[-2]
    r, c, n = eng.rr, eng.cc, eng.n
    table_bytes = limbs * (16 * r * r + 16 * c * c + 4 * n + 32)
    nbytes = 2 * 8 * polys * n + table_bytes
    ops = 2 * polys * (16 * r * r * c + 16 * r * c * c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels():
    import torch
    from lattigo_tpu_torch.presets import bgv_tpu_params
    from lattigo_tpu_torch.ring import ntt_mxu
    from lattigo_tpu_torch.ring.ring import Ring
    from lattigo_tpu_torch.rlwe.params import gen_moduli

    lit = bgv_tpu_params(LOG_N, LOG_QP)
    q, p = gen_moduli(LOG_N, 2 << LOG_N, lit.log_q, lit.log_p)
    ring = Ring(1 << LOG_N, q + p, device="cuda")
    check(ring.ntt_engine == "mxu-cuda", f"engine {ring.ntt_engine}")
    eng = ring._mxu
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randint(0, 1 << 62, (BATCH, len(q + p), ring.n), generator=gen,
                      device="cuda") % ring.q
    rows = []
    for inverse, name in ((False, "ntt_mxu_forward"), (True, "ntt_mxu_inverse")):
        err = 0
        for lazy in (False, True):
            got = ntt_mxu.four_step_cuda(eng, x, 0, inverse, lazy)
            want = ntt_mxu.four_step_plain(eng, x, 0, inverse, lazy)
            torch.cuda.synchronize()
            err = max(err, int((got - want).abs().max()))
            check(torch.equal(got, want), f"{name} lazy={lazy}: kernel != plain")
            check(bool((got < (2 if lazy else 1) * ring.q).all()),
                  f"{name} lazy={lazy}: output out of range")
        i = 5                                  # a single limb at offset 5
        xi = x[:, i:i + 1].contiguous()
        got = ntt_mxu.four_step_cuda(eng, xi, i, inverse, False)
        want = ntt_mxu.four_step_plain(eng, xi, i, inverse, False)
        full = ntt_mxu.four_step_cuda(eng, x, 0, inverse, False)[:, i:i + 1]
        check(torch.equal(got, want) and torch.equal(got, full),
              f"{name} at limb offset {i}: kernel != plain")
        ms = cuda_ms(lambda: ntt_mxu.four_step_cuda(eng, x, 0, inverse, False), 20)
        plain_ms = cuda_ms(lambda: ntt_mxu.four_step_plain(eng, x, 0, inverse, False), 3)
        bound_ms, bound_by = four_step_bound(eng, tuple(x.shape))
        rows.append(dict(
            name=name, route="cuda", source="lattigo_tpu_torch/csrc/ntt_mxu.cu",
            replaces=("lattigo_tpu/ring/ntt_mxu.py:269" if inverse
                      else "lattigo_tpu/ring/ntt_mxu.py:277"),
            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    y = ring.ntt(x)
    check(torch.equal(ring.intt(y), x), "NTT then INTT is not the identity")
    for r in rows:
        r["split"] = eng.split_for(BATCH * len(q + p), r["name"].endswith("inverse"))
    # the smaller rings the kernel has templates for, at 2 x 3 x N
    for logn in (12, 13):
        lit_s = bgv_tpu_params(logn, LOG_QP)
        qs, ps = gen_moduli(logn, 2 << logn, lit_s.log_q, lit_s.log_p)
        small = Ring(1 << logn, (qs + ps)[:3], device="cuda")
        check(small.ntt_engine == "mxu-cuda", f"logN={logn} on {small.ntt_engine}")
        xs = torch.randint(0, 1 << 62, (2, 3, small.n), generator=gen,
                           device="cuda") % small.q
        for r in rows:
            inverse = r["name"].endswith("inverse")
            for lazy in (False, True):
                got = ntt_mxu.four_step_cuda(small._mxu, xs, 0, inverse, lazy)
                want = ntt_mxu.four_step_plain(small._mxu, xs, 0, inverse, lazy)
                r["max_abs_err"] = max(r["max_abs_err"], int((got - want).abs().max()))
                check(torch.equal(got, want), f"{r['name']} logN={logn} "
                      f"lazy={lazy}: kernel != plain")
    print("phase 2 ntt_mxu: bit-equal to the plain version (lazy, not lazy, "
          "limb offset 5; and at logN 12 and 13 on 2x3xN), NTT->INTT "
          f"identity; at {BATCH}x{len(q + p)}x{ring.n}: " + ", ".join(
              f"{r['name']} {r['ms']:.4f} ms with split {r['split']} (plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']})" for r in rows))
    return rows


def record_calls(module, name: str, fn):
    """Run fn() with ``module.name`` (a kernel wrapper taking eng, x,
    limb_lo, inverse, lazy) recording the first input of every distinct
    call, the launch counts zeroed before and read after. Returns fn's
    result, {key: (eng, x, limb_lo, inverse, lazy)} and the counts."""
    import torch
    calls = {}
    launch = getattr(module, name)

    def recording(eng, x, limb_lo, inverse, lazy):
        key = (id(eng), tuple(x.shape), limb_lo, inverse, lazy)
        if key not in calls:
            calls[key] = (eng, x.clone(), limb_lo, inverse, lazy)
        return launch(eng, x, limb_lo, inverse, lazy)

    setattr(module, name, recording)
    try:
        module.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = dict(module.LAUNCHES)
    finally:
        setattr(module, name, launch)
    return out, calls, launches


def bgv_server():
    """Phase 3's server on the card: parameters, keys, the inputs a and b
    (BATCH requests), serve() (encrypt both, rescale(mul_relin), decrypt,
    decode; returns ca, cb and the decoded slots) and step(ca, cb)."""
    import numpy as np
    import torch
    from lattigo_tpu_torch import rlwe
    from lattigo_tpu_torch.presets import bgv_tpu_params
    from lattigo_tpu_torch.schemes import bgv

    params = bgv.Parameters(bgv_tpu_params(LOG_N, LOG_QP))   # on cuda
    check(params.ring_q.device.type == "cuda", "parameters not on the card")
    for name, ring in (("Q", params.ring_q), ("P", params.ring_p), ("T", params.ring_t)):
        check(ring.ntt_engine == "mxu-cuda", f"ring {name} on {ring.ntt_engine}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kg = rlwe.KeyGenerator(params)
    sk = kg.gen_secret_key(gen)
    rlk = kg.gen_relinearization_key(gen, sk)
    encoder = bgv.Encoder(params)
    encryptor = rlwe.Encryptor(params, sk)
    decryptor = rlwe.Decryptor(params, sk)
    ev = bgv.Evaluator(params, rlwe.EvaluationKeySet(rlk))
    rng = np.random.default_rng(SEED)
    a = rng.integers(0, params.t, (BATCH, params.n))
    b = rng.integers(0, params.t, (BATCH, params.n))

    def serve():
        ca = encryptor.encrypt(gen, encoder.encode(a), batch=(BATCH,))
        cb = encryptor.encrypt(gen, encoder.encode(b), batch=(BATCH,))
        out = ev.rescale(ev.mul_relin(ca, cb))
        return ca, cb, encoder.decode(decryptor.decrypt(out))

    def step(ca, cb):
        return ev.rescale(ev.mul_relin(ca, cb))

    return params, a, b, serve, step


def phase_server(rows):
    import numpy as np
    import torch
    from lattigo_tpu_torch.ring import ntt_mxu

    t0 = time.perf_counter()
    params, a, b, serve, step_of = bgv_server()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    (ca, cb, got), calls, launches = record_calls(ntt_mxu, "four_step_cuda", serve)
    launch = ntt_mxu.four_step_cuda
    check(np.array_equal(got, a * b % params.t), "decoded slots != a*b mod t")
    mxu_rows = [r for r in rows if r["name"].startswith("ntt_mxu")]
    for r in mxu_rows:
        inverse = r["name"].endswith("inverse")
        r["launches"] = launches["inverse" if inverse else "forward"]
        check(r["launches"] > 0, f"{r['name']} not launched on the main path")
    # each kernel against its plain version at the main path's own calls
    for eng, x, limb_lo, inverse, lazy in calls.values():
        k = launch(eng, x, limb_lo, inverse, lazy)
        want = ntt_mxu.four_step_plain(eng, x, limb_lo, inverse, lazy)
        for r in mxu_rows:
            if r["name"].endswith("inverse") == inverse:
                r["max_abs_err"] = max(r["max_abs_err"], int((k - want).abs().max()))
        check(torch.equal(k, want), f"kernel != plain at main-path call "
              f"{tuple(x.shape)} limb_lo={limb_lo} inverse={inverse}")
    shapes = sorted({(tuple(x.shape), lo, "inv" if inv else "fwd",
                      f"split {eng.split_for(x.numel() // eng.n, inv)}")
                     for eng, x, lo, inv, _ in calls.values()})

    def step():
        return step_of(ca, cb)

    ntt_mxu.reset_launches()
    step()
    torch.cuda.synchronize()
    step_launches = dict(ntt_mxu.LAUNCHES)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    reps = 10
    t1 = time.perf_counter()
    for _ in range(reps):
        out = step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / reps * 1e3
    check(out.level == params.max_level - 1, "rescale did not drop a level")
    t2 = time.perf_counter()
    serve()
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t2) * 1e3

    print(f"phase 3 server: BGV logN={LOG_N} Q={len(params.q_moduli)}x28-bit "
          f"P={len(params.p_moduli)}x28-bit T={params.t}, {BATCH} requests of "
          f"{params.n} slots decode to a*b mod T in every slot; rings Q, P, T on "
          f"mxu-cuda; kernel bit-equal to plain at the main path's "
          f"{len(calls)} distinct calls {shapes}; launches on the main path "
          f"{launches}, per step "
          f"{step_launches}; set-up {setup_s:.2f} s; step (mul_relin+rescale) "
          f"{step_ms:.3f} ms per batch of {BATCH}; whole request path "
          f"{serve_ms:.3f} ms")
    text, family = profile_step(step)
    print("phase 3 profile: " + text)
    for r in mxu_rows:
        # the kernel templates end in the direction flag: <..., true> inverse
        flag = "true>" if r["name"].endswith("inverse") else "false>"
        us = sum(v for k, (v, _) in family.items() if flag in k)
        n = sum(c for k, (_, c) in family.items() if flag in k)
        check(n > 0, f"{r['name']} absent from the step's profile")
        r["device_us_per_launch"] = us / n
    print("phase 3 ntt_mxu device time per launch: " + ", ".join(
        f"{r['name']} {r['device_us_per_launch']:.3f} us" for r in mxu_rows))


def device_kernels(fn, host: bool = True) -> tuple[float, dict]:
    """fn()'s wall µs under the profiler and {kernel name: (device µs,
    launches)}; ``host=False`` records device activity only (for runs of
    hundreds of thousands of host ops, whose trace would take minutes to
    sum)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if host else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return wall_us, {ev.key: (ev.self_device_time_total, ev.count)
                     for ev in prof.key_averages()
                     if ev.device_type == DeviceType.CUDA
                     and ev.self_device_time_total > 0}


def busy_text(wall_us: float, dev: dict) -> str:
    total = sum(v for v, _ in dev.values())
    return (f"wall {wall_us:.0f} us, {sum(n for _, n in dev.values())} device "
            f"kernels busy {total:.0f} us (idle share "
            f"{max(0.0, 1 - total / wall_us):.3f})")


def profile_step(step, kernel: str = "ntt_mxu_kernel",
                 host: bool = True) -> tuple[str, dict]:
    """Device time of one step by kernel, and the device's idle share of the
    step's wall time; ``kernel`` names the family whose share is reported
    (see :func:`device_kernels` for ``host``). Also returns {kernel name:
    (device us, launches)} of that family."""
    wall_us, dev = device_kernels(step, host)
    total = sum(v for v, _ in dev.values())
    if total == 0:
        return "not measured (no device time in the trace)", {}
    family = {k: vn for k, vn in dev.items() if kernel in k}
    ntt = sum(v for v, _ in family.values())
    ntt_n = sum(n for _, n in family.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:3]
    return (busy_text(wall_us, dev) + f", {kernel}s {ntt:.0f} us in {ntt_n} "
            f"launches ({ntt / total:.3f} of device time); top: " + "; ".join(
                f"{k[:50]} {v:.0f} us" for k, (v, _) in top)), family


def ckks_server():
    """Phase 5's server on the card: parameters, keys (Galois keys scoped to
    the transformation's level), the inputs a and b (BATCH requests), the
    encoded transformation, serve() (encrypt both, the step, decrypt,
    decode; returns ca, cb and the decoded slots), step(ca, cb), the numpy
    answer M·(a∘b) and what the set-up measured."""
    import numpy as np
    import torch
    from lattigo_tpu_torch import rlwe
    from lattigo_tpu_torch.circuits import lintrans
    from lattigo_tpu_torch.presets import ckks_tpu_params
    from lattigo_tpu_torch.schemes import ckks

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = ckks.Parameters(ckks_tpu_params(LOG_N, LOG_QP))   # on cuda
    check(params.ring_q.device.type == "cuda", "parameters not on the card")
    for name, ring in (("Q", params.ring_q), ("P", params.ring_p)):
        check(ring.ntt_engine == "mxu-cuda", f"ring {name} on {ring.ntt_engine}")
    slots = params.max_slots
    rng = np.random.default_rng(SEED)

    def uniform(bound, shape):
        return rng.uniform(-bound, bound, shape) + 1j * rng.uniform(-bound, bound, shape)

    a, b = uniform(1.0, (BATCH, slots)), uniform(1.0, (BATCH, slots))
    diags = {k: uniform(1.0 / CKKS_DIAGS, slots) for k in range(CKKS_DIAGS)}
    level = params.max_level - 1            # the transformation's level
    encoder = ckks.Encoder(params)
    lt = lintrans.encode_linear_transformation(
        params, diags, lintrans.ckks_diag_encoder(params, encoder, params.q_moduli[level]),
        level_q=level, scale=params.q_moduli[level], slots=slots)
    els = lt.galois_elements(params)
    check(lt.n1 == 4 and len(els) == 6, f"n1 {lt.n1} with {len(els)} Galois keys")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kg = rlwe.KeyGenerator(params)
    sk = kg.gen_secret_key(gen)
    rlk = kg.gen_relinearization_key(gen, sk)
    gks = kg.gen_galois_keys(gen, els, sk, levels={g: level for g in els})
    torch.cuda.synchronize()
    info = dict(setup_s=time.perf_counter() - t0, n1=lt.n1, galois_keys=len(gks),
                key_level=level, keys_peak_mb=torch.cuda.max_memory_allocated() / 2**20)
    ev = ckks.Evaluator(params, rlwe.EvaluationKeySet(rlk, gks))
    lte = lintrans.LinTransEvaluator(ev)
    encryptor = rlwe.Encryptor(params, sk)
    decryptor = rlwe.Decryptor(params, sk)
    ab = a * b
    want = np.zeros_like(ab)
    for k, d in diags.items():
        want += d * np.roll(ab, -k, axis=-1)

    def step(ca, cb):
        return ev.rescale(lte.evaluate(ev.rescale(ev.mul_relin(ca, cb)), lt))

    def serve():
        ca = encryptor.encrypt(gen, encoder.encode(a), batch=(BATCH,))
        cb = encryptor.encrypt(gen, encoder.encode(b), batch=(BATCH,))
        return ca, cb, encoder.decode(decryptor.decrypt(step(ca, cb)))

    return params, want, serve, step, info


def phase_ckks(rows):
    import numpy as np
    import torch
    from lattigo_tpu_torch.ring import ntt_mxu
    from lattigo_tpu_torch.schemes.ckks import get_precision_stats

    params, want, serve, step_of, info = ckks_server()
    (ca, cb, got), calls, launches = record_calls(ntt_mxu, "four_step_cuda", serve)
    launch = ntt_mxu.four_step_cuda
    check(got.shape == want.shape and bool(np.isfinite(got).all()),
          f"decoded slots of shape {got.shape}, not all finite")
    stats = get_precision_stats(want, got)
    check(stats.min_precision >= CKKS_MIN_BITS[0] and stats.avg_precision >= CKKS_MIN_BITS[1],
          f"CKKS precision {stats} below the floor min {CKKS_MIN_BITS[0]} / avg "
          f"{CKKS_MIN_BITS[1]} bits")
    mxu_rows = [r for r in rows if r["name"].startswith("ntt_mxu")]
    for r in mxu_rows:
        r["ckks_launches"] = launches["inverse" if r["name"].endswith("inverse") else "forward"]
        check(r["ckks_launches"] > 0, f"{r['name']} not launched on the CKKS path")
    for eng, x, limb_lo, inverse, lazy in calls.values():
        k = launch(eng, x, limb_lo, inverse, lazy)
        want_k = ntt_mxu.four_step_plain(eng, x, limb_lo, inverse, lazy)
        for r in mxu_rows:
            if r["name"].endswith("inverse") == inverse:
                r["max_abs_err"] = max(r["max_abs_err"], int((k - want_k).abs().max()))
        check(torch.equal(k, want_k), f"kernel != plain at CKKS call "
              f"{tuple(x.shape)} limb_lo={limb_lo} inverse={inverse}")
    shapes = sorted({(tuple(x.shape), lo, "inv" if inv else "fwd",
                      f"split {eng.split_for(x.numel() // eng.n, inv)}")
                     for eng, x, lo, inv, _ in calls.values()})

    def step():
        return step_of(ca, cb)

    ntt_mxu.reset_launches()
    out = step()
    torch.cuda.synchronize()
    step_launches = dict(ntt_mxu.LAUNCHES)
    for r in mxu_rows:
        r["ckks_launches_per_step"] = step_launches[
            "inverse" if r["name"].endswith("inverse") else "forward"]
    check(out.level == params.max_level - 2, "the step did not end two levels down")
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    reps = 10
    t1 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / reps * 1e3
    t2 = time.perf_counter()
    serve()
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t2) * 1e3
    # the decode's host CRT: one [12, N] polynomial to Python integers
    x = torch.randint(0, 1 << 27, (12, params.n), device="cuda")
    t3 = time.perf_counter()
    params.ring_q.to_int_coeffs(x, 11)
    crt_ms = (time.perf_counter() - t3) * 1e3
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    print(f"phase 5 ckks: CKKS logN={LOG_N} Q={len(params.q_moduli)}x28-bit "
          f"P={len(params.p_moduli)}x28-bit scale 2^{params.log_default_scale}; rings "
          f"Q, P on mxu-cuda; set-up {info['setup_s']:.2f} s with "
          f"{info['galois_keys']} Galois keys at level {info['key_level']} (n1 "
          f"{info['n1']}, {CKKS_DIAGS} diagonals), peak memory after keys "
          f"{info['keys_peak_mb']:.1f} MiB; {BATCH} requests of {params.max_slots} "
          f"slots, rescale(evaluate(rescale(mul_relin(a, b)))) decodes to M(a*b) "
          f"at {stats} (floor min {CKKS_MIN_BITS[0]} / avg {CKKS_MIN_BITS[1]}); "
          f"kernel bit-equal to plain at the request's {len(calls)} distinct calls "
          f"{shapes}; launches on the request {launches}, per step {step_launches}; "
          f"step {step_ms:.3f} ms per batch of {BATCH}; whole request path "
          f"{serve_ms:.3f} ms; host CRT of one 12-limb poly {crt_ms:.1f} ms; "
          f"peak memory of the phase {peak_mb:.1f} MiB")
    text, family = profile_step(step, host=False)
    print("phase 5 profile: " + text)
    for r in mxu_rows:
        flag = "true>" if r["name"].endswith("inverse") else "false>"
        us = sum(v for k, (v, _) in family.items() if flag in k)
        n = sum(c for k, (_, c) in family.items() if flag in k)
        check(n > 0, f"{r['name']} absent from the CKKS step's profile")
        r["ckks_device_us_per_launch"] = us / n


def aggregate(proto, shares):
    """Fold a list of shares with the protocol's aggregate_shares."""
    agg = shares[0]
    for sh in shares[1:]:
        agg = proto.aggregate_shares(agg, sh)
    return agg


def mp_flow(device, log_n: int, log_qp: int, timed):
    """Phase 6's main path at ``bgv_tpu_params(log_n, log_qp)`` (and the
    CKKS refresh at ``ckks_tpu_params(log_n, log_qp)``) on ``device``.

    ``timed(label, fn)`` runs fn() and returns its result (the phase times
    it and counts its launches under the label). Every BGV result is
    checked exactly here; returns the parameters, the keys and inputs the
    phase reuses, and the CKKS refresh's precision stats, which the caller
    holds at its floor."""
    import numpy as np
    import torch
    from lattigo_tpu_torch import multiparty as mp, rlwe
    from lattigo_tpu_torch.multiparty.sharing import (
        RefreshProtocol, get_minimum_level_for_refresh,
    )
    from lattigo_tpu_torch.presets import bgv_tpu_params, ckks_tpu_params
    from lattigo_tpu_torch.schemes import bgv, ckks
    from lattigo_tpu_torch.schemes.ckks import get_precision_stats

    params = bgv.Parameters(bgv_tpu_params(log_n, log_qp), device=device)
    cparams = ckks.Parameters(ckks_tpu_params(log_n, log_qp), device=device)
    top = params.max_level
    gens = [torch.Generator(device=device).manual_seed(SEED + i)
            for i in range(MP_PARTIES)]
    gen = torch.Generator(device=device).manual_seed(SEED + 100)   # the server
    active = [gens[x - 1] for x in MP_ACTIVE]
    rng = np.random.default_rng(SEED)
    a = rng.integers(0, params.t, (BATCH, params.n))
    b = rng.integers(0, params.t, (BATCH, params.n))
    half = params.n // 2
    ab = a * b % params.t
    want = np.concatenate([np.roll(ab[:, :half], -1, axis=-1),
                           np.roll(ab[:, half:], -1, axis=-1)], axis=-1)
    kg = rlwe.KeyGenerator(params)
    encoder = bgv.Encoder(params)

    def each(label, parties, fn):
        return [timed(label, lambda g=g, x=x: fn(g, x)) for g, x in parties]

    # 1. secret keys, Shamir shares, additive shares of the active set
    sks = [timed("sk", lambda g=g: kg.gen_secret_key(g)) for g in gens]
    th = mp.Thresholdizer(params)
    polys = each("shamir polynomial", zip(gens, sks),
                 lambda g, sk: th.gen_shamir_polynomial(g, MP_THRESHOLD, sk))

    def shamir_share(x):
        """Party x's Shamir share: every party's polynomial at x, summed."""
        acc = th.gen_shamir_secret_share(x, polys[0])
        for poly in polys[1:]:
            acc = mp.Thresholdizer.aggregate_shares(
                params, acc, th.gen_shamir_secret_share(x, poly))
        return acc

    shamir = [timed("shamir share", lambda x=x: shamir_share(x))
              for x in range(1, MP_PARTIES + 1)]
    comb = mp.Combiner(params, MP_THRESHOLD)
    tsks = [timed("combiner", lambda x=x: comb.gen_additive_share(
        list(MP_ACTIVE), x, shamir[x - 1])) for x in MP_ACTIVE]

    def protocol(name, proto, shares_of, finalize, keys=None):
        """One round by the active parties holding ``keys`` (their additive
        shares by default): gen_share each, aggregate, finalize."""
        shares = each(f"{name} gen_share", zip(active, keys or tsks), shares_of)
        agg = timed(f"{name} aggregate", lambda: aggregate(proto, shares))
        return timed(f"{name} finalize", lambda: finalize(agg))

    # 2. collective keys
    cpk_p = mp.PublicKeyGenProtocol(params)
    crp = timed("crp", lambda: cpk_p.sample_crp(b"mp-cpk"))
    cpk = protocol("cpk", cpk_p, lambda g, s: cpk_p.gen_share(g, s, crp),
                   lambda agg: cpk_p.finalize(agg, crp))
    rlk_p = mp.RelinearizationKeyGenProtocol(params)
    rlk_crps = timed("crp", lambda: rlk_p.sample_crp(b"mp-rlk"))

    def gen_rlk():
        eph = each("rlk ephemeral", zip(active, tsks), lambda g, s: rlk_p.gen_ephemeral(g))
        r1 = each("rlk round1 gen_share", zip(active, zip(tsks, eph)),
                  lambda g, se: rlk_p.gen_share_round1(g, se[0], se[1], rlk_crps))
        agg1 = timed("rlk round1 aggregate", lambda: aggregate(rlk_p, r1))
        r2 = each("rlk round2 gen_share", zip(active, zip(tsks, eph)),
                  lambda g, se: rlk_p.gen_share_round2(g, se[0], se[1], agg1))
        agg2 = timed("rlk round2 aggregate", lambda: aggregate(rlk_p, r2))
        return timed("rlk finalize", lambda: rlk_p.finalize(agg1, agg2))

    rlk = gen_rlk()
    gal = params.galois_element(1)
    gk_p = mp.GaloisKeyGenProtocol(params)
    gk_crps = timed("crp", lambda: gk_p.sample_crp(b"mp-gk"))
    gk = protocol("gk", gk_p, lambda g, s: gk_p.gen_share(g, gal, s, gk_crps),
                  lambda agg: gk_p.finalize(gal, agg, gk_crps))

    # 3.-5. inputs under the collective key, the step, collective decryption
    ev = bgv.Evaluator(params, rlwe.EvaluationKeySet(rlk, {gal: gk}))
    encryptor = rlwe.Encryptor(params, cpk)
    cks = mp.KeySwitchProtocol(params)

    def encrypt(x):
        return encryptor.encrypt(gen, encoder.encode(x), batch=(BATCH,))

    def step(ca, cb):
        return ev.rotate_columns(ev.rescale(ev.mul_relin(ca, cb)), 1)

    def decrypt(ct, keys, name="cks"):
        """Collective decryption: CKS to 0 by ``keys``, then decode."""
        agg = aggregate(cks, each(f"{name} gen_share", zip(active, keys),
                                  lambda g, s: cks.gen_share(g, s, None, ct)))
        out = timed(f"{name} key_switch", lambda: cks.key_switch(ct, agg))
        return encoder.decode(rlwe.Plaintext(value=out.value[..., 0, :, :],
                                             is_ntt=True, scale=out.scale))

    ca = timed("encrypt (pk)", lambda: encrypt(a))
    cb = timed("encrypt (pk)", lambda: encrypt(b))
    out = timed("step", lambda: step(ca, cb))
    check(out.level == top - 1, "the step did not drop a level")
    check(np.array_equal(decrypt(out, tsks), want), "CKS: slots != roll(a*b mod t)")

    # 6. public-key switch to a receiver's own key
    rgen = torch.Generator(device=device).manual_seed(SEED + 200)
    sk_r = kg.gen_secret_key(rgen)
    pk_r = timed("pk (receiver)", lambda: kg.gen_public_key(rgen, sk_r))
    pcks = mp.PublicKeySwitchProtocol(params)
    ct_r = protocol("pcks", pcks, lambda g, s: pcks.gen_share(g, s, pk_r, out),
                    lambda agg: pcks.key_switch(out, agg))
    got = encoder.decode(rlwe.Decryptor(params, sk_r).decrypt(ct_r))
    check(np.array_equal(got, want), "PCKS: slots != roll(a*b mod t)")

    # 7. key rotation: a collective key to a fresh committee key
    fresh = [timed("sk", lambda g=g: kg.gen_secret_key(g)) for g in active]
    evk_p = mp.EvaluationKeyGenProtocol(params)
    evk_crps = timed("crp", lambda: evk_p.sample_crp(b"mp-evk"))
    shares = each("evk gen_share", zip(active, zip(tsks, fresh)),
                  lambda g, ss: evk_p.gen_share(g, ss[0], ss[1], evk_crps))
    agg = timed("evk aggregate", lambda: aggregate(evk_p, shares))
    evk = timed("evk finalize", lambda: evk_p.finalize(agg, evk_crps))
    rotated = timed("apply evk", lambda: ev.apply_evaluation_key(out, evk))
    check(np.array_equal(decrypt(rotated, fresh, "cks (new committee)"), want),
          "EVK: slots != roll(a*b mod t) under the new committee")

    # 8. BGV refresh of one ciphertext back to the top level
    ref_p = mp.BGVRefreshProtocol(params)
    one = out.replace(value=out.value[0])
    ref_crp = timed("crp", lambda: ref_p.sample_crp(b"mp-bgv-refresh", top))
    fresh_ct = protocol("bgv refresh", ref_p,
                        lambda g, s: ref_p.gen_share(g, s, one, ref_crp, top),
                        lambda agg: ref_p.finalize(one, agg, ref_crp, top))
    check(fresh_ct.level == top, f"refreshed to level {fresh_ct.level}, not {top}")
    check(np.array_equal(decrypt(fresh_ct, tsks, "cks (refreshed)"), want[0]),
          "BGV refresh: slots != roll(a*b mod t)")

    # 9. CKKS refresh: three fresh parties, a vector at the least level
    ckg = rlwe.KeyGenerator(cparams)
    csks = [timed("sk", lambda g=g: ckg.gen_secret_key(g)) for g in active]
    ccpk_p = mp.PublicKeyGenProtocol(cparams)
    ccrp = timed("crp", lambda: ccpk_p.sample_crp(b"mp-ckks-cpk"))
    ccpk = protocol("ckks cpk", ccpk_p, lambda g, s: ccpk_p.gen_share(g, s, ccrp),
                    lambda agg: ccpk_p.finalize(agg, ccrp), csks)
    level, log_bound, ok = get_minimum_level_for_refresh(
        MP_REFRESH_LAMBDA, cparams.default_scale_fraction, len(MP_ACTIVE),
        cparams.q_moduli)
    check(ok and level == 1 and log_bound == 40,
          f"refresh level {level}, mask bits {log_bound}")
    crng = np.random.default_rng(SEED)
    slots = cparams.max_slots
    v = crng.uniform(-1, 1, slots) + 1j * crng.uniform(-1, 1, slots)
    cenc = ckks.Encoder(cparams)
    ct = rlwe.Encryptor(cparams, ccpk).encrypt(gen, cenc.encode(v, level=level))
    cref = RefreshProtocol(cparams, log_bound=log_bound)
    ctop = cparams.max_level
    s2e_crp = timed("crp", lambda: cref.s2e.sample_crp(b"mp-ckks-refresh", ctop))
    e2s, s2e = [], []
    for g, s in zip(active, csks):
        mask, h = timed("ckks refresh gen_share", lambda g=g, s=s: cref.e2s.gen_share(g, s, ct))
        e2s.append(h)
        s2e.append(timed("ckks refresh gen_share",
                         lambda g=g, s=s, mask=mask: cref.s2e.gen_share(g, s, mask, s2e_crp, ctop)))

    def finalize_refresh():
        pub = cref.e2s.finalize_public(ct, aggregate(cref.e2s, e2s))
        return cref.s2e.finalize(aggregate(cref.s2e, s2e), s2e_crp,
                                 extra_c0=cref.lift_public(pub, level, ctop),
                                 scale=ct.scale, level=ctop)

    cfresh = timed("ckks refresh finalize", finalize_refresh)
    check(cfresh.level == ctop, f"CKKS refreshed to level {cfresh.level}, not {ctop}")
    ccks = mp.KeySwitchProtocol(cparams)
    cout = protocol("ckks cks", ccks, lambda g, s: ccks.gen_share(g, s, None, cfresh),
                    lambda agg: ccks.key_switch(cfresh, agg), csks)
    got = cenc.decode(rlwe.Plaintext(value=cout.value[0], is_ntt=True, scale=cout.scale))
    check(got.shape == v.shape and bool(np.isfinite(got).all()),
          f"CKKS refresh decoded to shape {got.shape}, not all finite")
    return dict(params=params, cparams=cparams, a=a, b=b, want=want, ev=ev,
                encrypt=encrypt, step=step, decrypt=decrypt, gen_rlk=gen_rlk,
                tsks=tsks, refresh_level=level, refresh_log_bound=log_bound,
                ckks_stats=get_precision_stats(v, got))


def phase_multiparty(rows):
    import numpy as np
    import torch
    from lattigo_tpu_torch.ring import ntt_mxu

    torch.cuda.reset_peak_memory_stats()
    stats = {}                      # label -> [ms, forward, inverse, calls]
    quiet = [False]

    def timed(label, fn):
        if quiet[0]:
            return fn()
        torch.cuda.synchronize()
        f0, i0 = ntt_mxu.LAUNCHES["forward"], ntt_mxu.LAUNCHES["inverse"]
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        st = stats.setdefault(label, [0.0, 0, 0, 0])
        st[0] += (time.perf_counter() - t0) * 1e3
        st[1] += ntt_mxu.LAUNCHES["forward"] - f0
        st[2] += ntt_mxu.LAUNCHES["inverse"] - i0
        st[3] += 1
        return out

    t0 = time.perf_counter()
    res, calls, launches = record_calls(
        ntt_mxu, "four_step_cuda", lambda: mp_flow("cuda", LOG_N, LOG_QP, timed))
    run_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    quiet[0] = True                 # timed() adds nothing from here on
    params = res["params"]
    for name, ring in (("Q", params.ring_q), ("P", params.ring_p), ("T", params.ring_t),
                       ("CKKS Q", res["cparams"].ring_q), ("CKKS P", res["cparams"].ring_p)):
        check(ring.ntt_engine == "mxu-cuda", f"ring {name} on {ring.ntt_engine}")
    cst = res["ckks_stats"]
    check(cst.min_precision >= MP_REFRESH_MIN_BITS[0]
          and cst.avg_precision >= MP_REFRESH_MIN_BITS[1],
          f"CKKS refresh precision {cst} below the floor min {MP_REFRESH_MIN_BITS[0]} "
          f"/ avg {MP_REFRESH_MIN_BITS[1]} bits")
    mxu_rows = [r for r in rows if r["name"].startswith("ntt_mxu")]
    for r in mxu_rows:
        r["mp_launches"] = launches["inverse" if r["name"].endswith("inverse") else "forward"]
        check(r["mp_launches"] > 0, f"{r['name']} not launched on the multiparty path")
    launch = ntt_mxu.four_step_cuda
    for eng, x, limb_lo, inverse, lazy in calls.values():
        k = launch(eng, x, limb_lo, inverse, lazy)
        want_k = ntt_mxu.four_step_plain(eng, x, limb_lo, inverse, lazy)
        for r in mxu_rows:
            if r["name"].endswith("inverse") == inverse:
                r["max_abs_err"] = max(r["max_abs_err"], int((k - want_k).abs().max()))
        check(torch.equal(k, want_k), f"kernel != plain at multiparty call "
              f"{tuple(x.shape)} limb_lo={limb_lo} inverse={inverse}")
    shapes = sorted({(tuple(x.shape), lo, "inv" if inv else "fwd")
                     for _, x, lo, inv, _ in calls.values()})
    crp_ms = stats["crp"][0]

    # the step and the request, after the recorded run
    step, encrypt, decrypt = res["step"], res["encrypt"], res["decrypt"]
    ca, cb = encrypt(res["a"]), encrypt(res["b"])
    for _ in range(3):
        step(ca, cb)
    torch.cuda.synchronize()
    reps = 10
    t1 = time.perf_counter()
    for _ in range(reps):
        step(ca, cb)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / reps * 1e3

    def request():
        return decrypt(step(encrypt(res["a"]), encrypt(res["b"])), res["tsks"])

    t2 = time.perf_counter()
    got = request()
    torch.cuda.synchronize()
    request_ms = (time.perf_counter() - t2) * 1e3
    check(np.array_equal(got, res["want"]), "request: slots != roll(a*b mod t)")

    def fmt(label):
        ms, f, i, n = stats[label]
        return f"{label} {ms / n:.2f} ms" + (f" x{n}" if n > 1 else "") + (
            f" [{f}/{i}]" if f or i else "")

    print(f"phase 6 multiparty: BGV logN={LOG_N} Q={len(params.q_moduli)}x28-bit "
          f"P={len(params.p_moduli)}x28-bit T={params.t}; {MP_PARTIES} parties, "
          f"threshold {MP_THRESHOLD}, active {list(MP_ACTIVE)}; collective pk, rlk "
          f"(2 rounds), gk; {BATCH} requests rotate_columns(rescale(mul_relin(a, b)), "
          f"1) decode to roll(a*b mod T) in every slot after CKS, after PCKS to a "
          f"receiver's key, after a collective EVK to a fresh committee (then its "
          f"CKS) and, for one ciphertext, after BGV refresh to level "
          f"{params.max_level}; CKKS refresh from level {res['refresh_level']} to "
          f"{res['cparams'].max_level} with {res['refresh_log_bound']}-bit masks at "
          f"{cst} (floor min {MP_REFRESH_MIN_BITS[0]} / avg {MP_REFRESH_MIN_BITS[1]}); "
          f"the run {run_s:.2f} s; kernel bit-equal to plain at the run's "
          f"{len(calls)} distinct calls; launches on the run {launches}; CRPs "
          f"{crp_ms:.1f} ms on the host in {stats['crp'][3]} samplings; step "
          f"{step_ms:.3f} ms per batch of {BATCH}; request (encrypt under the "
          f"collective key, step, CKS, decode) {request_ms:.3f} ms; peak memory of "
          f"the run {peak_mb:.1f} MiB")
    print("phase 6 protocols (mean ms per call [four-step forward/inverse "
          "launches in sum]): " + "; ".join(fmt(k) for k in stats))
    print(f"phase 6 four-step shapes: {shapes}")
    text, _ = profile_step(res["gen_rlk"], host=False)
    print("phase 6 profile (collective rlk, 3 parties, 2 rounds): " + text)
    text, family = profile_step(request, host=False)
    print("phase 6 profile (request): " + text)
    for r in mxu_rows:
        flag = "true>" if r["name"].endswith("inverse") else "false>"
        us = sum(v for k, (v, _) in family.items() if flag in k)
        n = sum(c for k, (_, c) in family.items() if flag in k)
        check(n > 0, f"{r['name']} absent from the multiparty request's profile")
        r["mp_device_us_per_launch"] = us / n


def u32_bound(eng, shape) -> tuple[float, str]:
    """Least time for one u32 call on x int64[shape]: 16 bytes a
    coefficient (int64 in and out) plus the used limbs' root table and
    constants, against logN·N/2 butterflies a row on the int32 ALUs."""
    rows = 1
    for d in shape[:-1]:
        rows *= d
    limbs, n = shape[-2], eng.n
    nbytes = 16 * rows * n + limbs * (4 * n + 16)
    ops = rows * eng.logn * (n // 2) * U32_OPS_PER_BUTTERFLY
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def br_params(device="cuda"):
    """Lattigo's blind-rotation parameters (core/rgsw/blindrot tests and
    BenchmarkHEBin): BR ring logN 10, Q = 0x7fff801, with the RNS gadget's
    P = 536881153 (the first 29-bit draw of gen_moduli(10, 2048)); LWE ring
    logN 9, Q = 0x3001, no P."""
    from lattigo_tpu_torch import rlwe
    pbr = rlwe.Parameters(rlwe.ParametersLiteral(
        log_n=10, q=(0x7FFF801,), p=(536881153,)), device=device)
    plwe = rlwe.Parameters(rlwe.ParametersLiteral(log_n=9, q=(0x3001,)),
                           device=device)
    return pbr, plwe


def check_u32(ring, x, limb: int | None) -> int:
    """Kernel against plain version on x, both directions, lazy and not, at
    a limb offset, and NTT->INTT identity; returns the largest |difference|."""
    import torch
    from lattigo_tpu_torch.ring import ntt_pallas
    eng, err = ring._u32, 0
    for inverse in (False, True):
        xin = ntt_pallas.u32_plain(eng, x, 0, False, True) if inverse else x
        for lazy in (False, True):
            got = ntt_pallas.u32_cuda(eng, xin, 0, inverse, lazy)
            want = ntt_pallas.u32_plain(eng, xin, 0, inverse, lazy)
            torch.cuda.synchronize()
            err = max(err, int((got - want).abs().max()))
            check(torch.equal(got, want), f"u32 inverse={inverse} lazy={lazy} "
                  f"at {tuple(x.shape)}: kernel != plain")
            bound = (2 if inverse else 4) if lazy else 1
            check(bool((got < bound * ring.q).all()), "u32 output out of range")
        if limb is not None:
            xi = x[:, limb:limb + 1].contiguous()
            got = ntt_pallas.u32_cuda(eng, xi, limb, inverse, False)
            want = ntt_pallas.u32_plain(eng, xi, limb, inverse, False)
            full = ntt_pallas.u32_cuda(eng, x, 0, inverse, False)[:, limb:limb + 1]
            check(torch.equal(got, want) and torch.equal(got, full),
                  f"u32 inverse={inverse} at limb offset {limb}: kernel != plain")
    check(torch.equal(ring.intt(ring.ntt(x)), x), "u32 NTT then INTT is not the identity")
    return err


def phase_u32_kernels(rows):
    """The u32 kernel at the blind rotation's shape and at the bulk shape."""
    import torch
    from lattigo_tpu_torch.ring import ntt_pallas
    from lattigo_tpu_torch.ring.ring import Ring
    from lattigo_tpu_torch.utils.primes import NTTFriendlyPrimesGenerator

    pbr, _ = br_params()
    n_bulk = 1 << LOG_N
    bulk_q = NTTFriendlyPrimesGenerator(29, 2 * n_bulk).next_alternating_primes(15)
    bulk = Ring(n_bulk, bulk_q, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = {}
    for tag, ring, batch, limb in (("path", pbr.ring_q, (2,), None),
                                   ("bulk", bulk, (BATCH,), 5)):
        check(ring.ntt_engine == "u32-cuda", f"{tag} ring on {ring.ntt_engine}")
        x = torch.randint(0, 1 << 62, batch + (len(ring.moduli), ring.n),
                          generator=gen, device="cuda") % ring.q
        err = check_u32(ring, x, limb)
        xi = ntt_pallas.u32_plain(ring._u32, x, 0, False, True)
        for inverse in (False, True):
            xin = xi if inverse else x
            reps = 200 if tag == "path" else 20
            ms = cuda_ms(lambda: ntt_pallas.u32_cuda(ring._u32, xin, 0, inverse, False), reps)
            plain_ms = cuda_ms(lambda: ntt_pallas.u32_plain(ring._u32, xin, 0, inverse, False), 3)
            bound_ms, bound_by = u32_bound(ring._u32, tuple(x.shape))
            shapes[(tag, inverse)] = dict(shape=list(x.shape), ms=ms, plain_ms=plain_ms,
                                          bound_ms=bound_ms, bound_by=bound_by, err=err)
            if tag == "path":
                shapes[(tag, inverse)]["host_us"] = host_us_per_call(
                    lambda: ntt_pallas.u32_cuda(ring._u32, xin, 0, inverse, False))
    out = []
    for inverse, name, line in ((False, "ntt_u32_forward", 111), (True, "ntt_u32_inverse", 135)):
        p, b = shapes[("path", inverse)], shapes[("bulk", inverse)]
        out.append(dict(
            name=name, route="cuda", source="lattigo_tpu_torch/csrc/ntt_pallas.cu",
            replaces=f"lattigo_tpu/ring/ntt_pallas.py:{line}", launches=None,
            max_abs_err=max(p["err"], b["err"]), ms=p["ms"], plain_ms=p["plain_ms"],
            bound_ms=p["bound_ms"], bound_by=p["bound_by"], library_ms=None,
            device_us_per_launch=None, host_us_per_call=p["host_us"],
            shape=p["shape"], bulk_shape=b["shape"], bulk_ms=b["ms"],
            bulk_plain_ms=b["plain_ms"], bulk_bound_ms=b["bound_ms"],
            bulk_bound_by=b["bound_by"]))
    print("phase 2 ntt_u32: bit-equal to the plain version (lazy, not lazy, "
          "limb offset 5 at the bulk shape), NTT->INTT identity; " + ", ".join(
              f"{r['name']} {r['ms']:.4f} ms at {r['shape']} (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms by {r['bound_by']}; host "
              f"{r['host_us_per_call']:.2f} us per call) and {r['bulk_ms']:.4f} ms "
              f"at {r['bulk_shape']} (plain {r['bulk_plain_ms']:.4f} ms, bound "
              f"{r['bulk_bound_ms']:.4f} ms by {r['bulk_bound_by']})" for r in out))
    rows.extend(out)


def sign(x: float) -> float:
    return 1.0 if x > 0 else (-1.0 if x < 0 else 0.0)


def phase_blindrot(rows):
    import numpy as np
    import torch
    from lattigo_tpu_torch import rlwe
    from lattigo_tpu_torch.rgsw import blindrot
    from lattigo_tpu_torch.ring import ntt_pallas

    pbr, plwe = br_params()
    rings = {"BR Q": pbr.ring_q, "BR P": pbr.ring_p, "LWE Q": plwe.ring_q}
    for name, ring in rings.items():
        check(ring.ntt_engine == "u32-cuda", f"ring {name} on {ring.ntt_engine}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    sk_lwe = rlwe.KeyGenerator(plwe).gen_secret_key(gen)
    sk_br = rlwe.KeyGenerator(pbr).gen_secret_key(gen)
    brk = blindrot.gen_evaluation_keys(gen, pbr, sk_br, plwe, sk_lwe)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    check(len(brk.brk) == plwe.n and len(brk.evk.galois_keys) == 11,
          "wrong number of blind-rotation keys")

    q_lwe, q_br = plwe.q_moduli[0], pbr.q_moduli[0]
    values = [-1 + 2 * i / BR_SLOTS for i in range(BR_SLOTS)]
    coeffs = [0] * plwe.n
    for i, v in enumerate(values):
        coeffs[i] = int(round(v * q_lwe / 4.0))
    f = blindrot.init_test_polynomial(sign, q_br / 4.0, pbr, -1.0, 1.0)
    encryptor = rlwe.Encryptor(plwe, sk_lwe)
    decryptor = rlwe.Decryptor(pbr, sk_br)
    ev = blindrot.BlindRotationEvaluator(pbr, plwe)

    lut_ms = []

    def run():
        pt = rlwe.Plaintext(value=plwe.ring_q.ntt(plwe.ring_q.from_int_coeffs(coeffs, 0), 0))
        ct = encryptor.encrypt(gen, pt)
        out = {}
        for i in range(BR_SLOTS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out.update(ev.evaluate(ct, {i: f}, brk))
            torch.cuda.synchronize()
            lut_ms.append((time.perf_counter() - t1) * 1e3)
        got = []
        for i in range(BR_SLOTS):
            ptb = decryptor.decrypt(out[i])
            c = int(pbr.ring_q.intt(ptb.value)[0, 0])
            got.append((c - q_br if c >= q_br // 2 else c) / (q_br / 4.0))
        return ct, got

    (ct, got), calls, launches = record_calls(ntt_pallas, "u32_cuda", run)
    launch = ntt_pallas.u32_cuda
    for i, v in enumerate(values):
        if v != 0:
            check(abs(round(got[i] * 8) / 8 - sign(v)) < 0.25,
                  f"slot {i}: blind rotation of sign at {v} gave {got[i]:.4f}")
    for r in rows:
        if r["name"].startswith("ntt_u32"):
            r["launches"] = launches["inverse" if r["name"].endswith("inverse") else "forward"]
            check(r["launches"] > 0, f"{r['name']} not launched on the blind-rotation path")
    for eng, x, limb_lo, inverse, lazy in calls.values():
        k = launch(eng, x, limb_lo, inverse, lazy)
        want = ntt_pallas.u32_plain(eng, x, limb_lo, inverse, lazy)
        for r in rows:
            if r["name"] == ("ntt_u32_inverse" if inverse else "ntt_u32_forward"):
                r["max_abs_err"] = max(r["max_abs_err"], int((k - want).abs().max()))
        check(torch.equal(k, want), f"u32 kernel != plain at blind-rotation call "
              f"{tuple(x.shape)} limb_lo={limb_lo} inverse={inverse}")
    shapes = sorted({(tuple(x.shape), lo, "inv" if inv else "fwd")
                     for _, x, lo, inv, _ in calls.values()})
    per_lut = {k: v / BR_SLOTS for k, v in launches.items()}
    print(f"phase 4 blind rotation: BR logN={pbr.log_n} Q={pbr.q_moduli} "
          f"P={pbr.p_moduli}, LWE logN={plwe.log_n} Q={plwe.q_moduli}; rings "
          f"{', '.join(rings)} on u32-cuda; keys ({len(brk.brk)} RGSW, "
          f"{len(brk.evk.galois_keys)} Galois) in {keygen_s:.3f} s; {BR_SLOTS} LUTs "
          f"decode to sign(x) in every slot with x != 0 (got "
          f"{[round(g, 4) for g in got]}); per LUT {np.mean(lut_ms):.3f} ms mean "
          f"(min {min(lut_ms):.3f}, max {max(lut_ms):.3f}, first {lut_ms[0]:.3f}); "
          f"u32 launches {launches} in the run, {per_lut} per LUT; kernel "
          f"bit-equal to plain at the run's {len(calls)} distinct calls {shapes}")
    text, family = profile_step(lambda: ev.evaluate(ct, {1: f}, brk),
                                kernel="ntt_u32_kernel", host=False)
    print("phase 4 profile (one LUT): " + text)
    for r in rows:
        if r["name"].startswith("ntt_u32"):
            # the kernel templates end in the direction flag: <..., true> inverse
            flag = "true>" if r["name"].endswith("inverse") else "false>"
            us = sum(v for k, (v, _) in family.items() if flag in k)
            n = sum(c for k, (_, c) in family.items() if flag in k)
            check(n > 0, f"{r['name']} absent from the LUT profile")
            r["device_us_per_launch"] = us / n
    print("phase 4 u32 device time per launch: " + ", ".join(
        f"{r['name']} {r['device_us_per_launch']:.3f} us" for r in rows
        if r["name"].startswith("ntt_u32")))


def kernel_family(name: str) -> str:
    """A device kernel's family: its template's name, with the (up to two)
    functors or ops it was instantiated for where the name carries them."""
    head = re.split(r"[<(]", name, maxsplit=1)[0].replace("void ", "").strip()
    found = []
    for tok in re.findall(r"(\w+(?:Functor|_kernel_cuda|_kernel_impl|_kernel))\b",
                          name[len(head):]):
        if not tok.startswith("gpu_") and tok not in found:
            found.append(tok)
    base = head.split("::")[-1]
    return f"{base}[{'/'.join(found[:2])}]" if found else base


def profile_families(fn) -> str:
    """Device kernels, busy µs and idle share of fn()'s wall time, and the
    three kernel families that took the most device time (device activity
    only: a trace of a host-bound stage of ~10^5 kernels)."""
    wall_us, dev = device_kernels(fn, host=False)
    if not dev:
        return "not measured (no device time in the trace)"
    fam = {}
    for k, (v, n) in dev.items():
        f = fam.setdefault(kernel_family(k), [0.0, 0])
        f[0] += v
        f[1] += n
    top = sorted(fam.items(), key=lambda kv: -kv[1][0])[:3]
    return busy_text(wall_us, dev) + "; top families: " + "; ".join(
        f"{k} {v:.0f} us in {n}" for k, (v, n) in top)


class OpCounter:
    """Counts the aten ops torch dispatches (views included) while active,
    and those dispatched inside the plain radix-2 NTT / INTT."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from lattigo_tpu_torch.ring import ntt as ntt_mod
        counter = self
        self.total = self.in_ntt = self.ntt_calls = 0
        self._depth = 0
        self._ntt_mod = ntt_mod
        self._orig = (ntt_mod.ntt, ntt_mod.intt)

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.total += 1
                counter.in_ntt += counter._depth > 0
                return func(*args, **(kwargs or {}))

        self._mode = Mode()

    def _wrap(self, fn):
        def wrapped(*a, **kw):
            self.ntt_calls += 1
            self._depth += 1
            try:
                return fn(*a, **kw)
            finally:
                self._depth -= 1
        return wrapped

    def __enter__(self):
        self._ntt_mod.ntt, self._ntt_mod.intt = (self._wrap(f) for f in self._orig)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._ntt_mod.ntt, self._ntt_mod.intt = self._orig


def bootstrap_flow(device, log_n: int | None, timed):
    """The bootstrap phase's main path at ``BTP_PRESET`` (its logN cut to
    ``log_n`` when given, for a rehearsal on the CPU), set up by the
    library's ``prepare_recipe`` with the seed ``SEED``: the keys each from
    its own generator on ``device``, the DFT matrices, and 2^(logN-1)
    complex slots encrypted at the minimum input level. ``timed(label,
    fn)`` runs each set-up step fn() and returns its result. Returns the
    objects and run(on_stage) (one bootstrap of the input) and bits(out)
    (worst and mean bits of the decrypted, decoded output)."""
    import numpy as np
    from lattigo_tpu_torch.circuits import bootstrapping_presets as bp

    r = bp.prepare_recipe(getattr(bp, BTP_PRESET), log_n=log_n, seed=SEED,
                          data_seed=SEED, device=device, timed=timed)
    btp, ct, keys, v = r["evaluator"], r["ct"], r["keys"], r["slots"]

    def run(on_stage=None):
        return btp.bootstrap(ct, keys, on_stage=on_stage)

    def bits(out):
        got = r["decode"](out)
        check(got.shape == v.shape and bool(np.isfinite(got).all()),
              f"bootstrapped slots of shape {got.shape}, not all finite")
        return bp.precision_bits(got, v)

    return dict(params=r["params"], btp=btp, run=run, bits=bits,
                galois_keys=len(r["galois_keys"]),
                key_levels=sorted(set(btp.galois_element_levels().values())),
                input_level=ct.level)


def phase_bootstrap(rows, log_n: int | None = None):
    import numpy as np
    import torch
    from lattigo_tpu_torch.ring import ntt_mxu, ntt_pallas

    gc.collect()
    torch.cuda.empty_cache()
    held_mb = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    setup = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        setup[label] = (time.perf_counter() - t0) * 1e3
        return out

    res = bootstrap_flow("cuda", log_n, timed)
    params, btp = res["params"], res["btp"]
    engines = {name: ring.ntt_engine for name, ring in
               (("Q", params.ring_q), ("P", params.ring_p))}
    for name, eng in engines.items():
        check(eng == "radix2-plain", f"bootstrap ring {name} on {eng}")
    keys_mb = torch.cuda.max_memory_allocated() / 2**20
    resident_mb = torch.cuda.memory_allocated() / 2**20

    # one untimed warm-up bootstrap, its dispatched torch ops counted
    with OpCounter() as ops:
        warm = res["run"]()
        torch.cuda.synchronize()
    check(warm.level == btp.output_level, f"output level {warm.level}")

    marks = {}

    def mark(name, ct):
        torch.cuda.synchronize()
        marks[name] = (time.perf_counter(), ct)

    ntt_mxu.reset_launches()
    ntt_pallas.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = res["run"](mark)
    launches = {"ntt_mxu": dict(ntt_mxu.LAUNCHES), "ntt_pallas": dict(ntt_pallas.LAUNCHES)}
    for r in rows:
        r["btp_launches"] = launches["ntt_mxu" if r["name"].startswith("ntt_mxu")
                                     else "ntt_pallas"][
            "inverse" if r["name"].endswith("inverse") else "forward"]
    check(all(v == 0 for d in launches.values() for v in d.values()),
          f"a kernel launched on the radix2-plain bootstrap: {launches}")
    t = {k: (v[0] - t0) * 1e3 for k, v in marks.items()}
    stage_ms = {"ScaleDown+encapsulation+ModUp": t["pre"],
                "C2S": t["c2s im"] - t["pre"],
                "EvalMod re": t["mod1 re"] - t["c2s im"],
                "EvalMod im": t["mod1 im"] - t["mod1 re"],
                "S2C": t["out"] - t["mod1 im"]}
    check(torch.equal(out.value, warm.value), "two bootstraps of one input differ")
    worst, mean = res["bits"](out)
    check(worst >= BTP_MIN_BITS[0] and mean >= BTP_MIN_BITS[1],
          f"bootstrap precision worst {worst:.2f} / mean {mean:.2f} bits below "
          f"the floor {BTP_MIN_BITS[0]} / {BTP_MIN_BITS[1]}")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    phase_s = time.perf_counter() - t_phase
    scale = float(out.scale)
    print(f"phase 7 bootstrap: CKKS {BTP_PRESET} logN={params.log_n} "
          f"Q={[q.bit_length() for q in params.q_moduli]} "
          f"P={[p.bit_length() for p in params.p_moduli]} H=192 main / H=32 "
          f"ephemeral secret; rings Q, P on {engines['Q']} / {engines['P']}; "
          f"set-up ms: " + ", ".join(f"{k} {v:.1f}" for k, v in setup.items())
          + f" ({res['galois_keys']} Galois keys at levels {res['key_levels']}); "
          f"{params.max_slots} slots from level {res['input_level']}: bootstrap "
          f"{t['out']:.1f} ms, by stage " + ", ".join(
              f"{k} {v:.1f}" for k, v in stage_ms.items())
          + f" ms; output level {out.level}, scale 2^{np.log2(scale):.4f}; "
          f"precision worst {worst:.2f} / mean {mean:.2f} bits (floor "
          f"{BTP_MIN_BITS[0]} / {BTP_MIN_BITS[1]}); kernel launches on the "
          f"bootstrap {launches}; {ops.total} dispatched torch ops per bootstrap, "
          f"{ops.in_ntt} ({ops.in_ntt / ops.total:.3f}) inside {ops.ntt_calls} "
          f"radix-2 NTT/INTT calls; peak device memory {peak_mb:.1f} MiB "
          f"({keys_mb:.1f} over the set-up, {resident_mb:.1f} resident after it; "
          f"{held_mb:.1f} held by earlier phases at the start); the phase "
          f"{phase_s:.1f} s")
    ct_re = marks["c2s re"][1]
    print("phase 7 profile (one EvalMod half): "
          + profile_families(lambda: btp.eval_mod(ct_re)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (HERE / "lattigo_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: lattigo_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import lattigo_tpu_torch
    check(Path(lattigo_tpu_torch.__file__).resolve().parent.parent == HERE,
          "lattigo_tpu_torch imported from outside this checkout")
    phase_build()
    rows = phase_kernels()
    phase_u32_kernels(rows)
    phase_server(rows)
    phase_blindrot(rows)
    phase_ckks(rows)
    phase_multiparty(rows)
    phase_bootstrap(rows)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
