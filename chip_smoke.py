#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero before the result):

1. build every CUDA kernel of the paths from ``lattigo_tpu_torch/csrc``
   and the native host XOF (one ``nvcc`` or ``g++`` per source, started
   together);
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
   its split), and the ModUp digit-matmul contractions of that run counted;
   then the step is timed after a warm-up and profiled once,
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
   version, the ModUp digit-matmul contractions of the run counted; per
   protocol the ms of gen_share (per party), aggregate and finalize and its
   four-step launches; the CRPs' host ms (the native XOF); the step and
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
   counted (and those inside the NTT engine, with its calls); then one
   bootstrap timed by
   stage (ScaleDown + encapsulation + ModUp, C2S, EvalMod on each half,
   S2C, each ending in a synchronize), equal to the warm-up's output,
   decrypted, decoded and held at a precision floor set from the JAX
   package's full-degree result less a bit; the rings' NTT engine
   (mxu64-plain, the u64 four-step engine of library matmuls: no kernel of
   this repository runs here, and the kernels' launch counts over the
   bootstrap must be 0); the output level and
   scale; peak device memory; one EvalMod half profiled (device kernels,
   busy us, idle share, the top three kernel families);
8. the remaining circuits, every earlier phase's tensors freed and the
   peak memory counter reset. 8a on BGV ``bgv_tpu_params(14, 438)``, a
   batch of 4: the exact Paterson-Stockmeyer ``BGVPolynomialEvaluator``
   on the degree-7 polynomial of the reference's test and on a seeded
   degree-31 one, and two BFV ``mul_scale_invariant`` (relinearized, no
   rescale; the auxiliary ring QMul of 61-bit primes is radix2-plain:
   half of them lie just above 2^61, off the u64 four-step engine's
   range), every slot equal to numpy's result mod T. 8b on CKKS
   ``ckks_tpu_params(14, 438)`` with a relinearization key, the
   conjugation key and a secret-key bootstrapper (decrypt, re-encode,
   re-encrypt): ``ComparisonEvaluator``
   ``step`` on ±[2^-8, 1] and ``max`` with |a - b| in [2^-8, 1] through a
   sign of 10 X4 composite stages, and ``InverseEvaluator`` Goldschmidt on
   [2^-4, 1] with automatic iterations; then ``evaluate_full_domain`` on
   ±[2^-3, 2^2] on the published ``CKKS_COMPLEX_PARAMS_N14_QP438`` chain
   (mxu64-plain), whose q0 holds 1/x at level 0, with a bootstrapper
   that reports minimum input level 1. Each CKKS result is
   held at a floor set from the JAX package's result on the same
   parameters, flow and inputs less a bit. The rings' engines are checked
   (Q, P, T four-step; QMul radix-2; the inverse's u64 four-step); launch counts
   zeroed before the circuits run once and read after, every distinct
   four-step call held against the plain version; per circuit the ms
   (mean of 3 after that run), its SK bootstraps, levels in and out and
   four-step launches; peak device memory; one X4 stage profiled;
9. the conjugate-invariant ring, the CKKS domain switcher, ring packing
   and the sparse and CI bootstraps, every earlier phase's tensors freed
   and the peak memory counter reset before each half. 9a on CKKS
   ``ckks_tpu_params(14, 438)``, its conjugate-invariant twin (the same
   primes at logN 13, 8192 real slots) and the standard ring at logN 13 on
   those primes: a batch of 4 real vectors through ``CIEncoder`` and
   ``rotate(rescale(mul_relin(a, b)), 1)`` on the CI ring; a batch of 4
   complex ciphertexts through ``complex_to_real`` (Re(m) at twice the
   scale) and ``real_to_complex`` (Re(m) + 0i); each held at a floor set
   from the JAX package's result on the same parameters, flow and inputs
   less a bit. ``RingPackingEvaluator`` on a logN-14 ciphertext of
   coefficients m * 2^32: ``extract`` of 8 indices into logN-13
   ciphertexts and ``repack``, ``split`` + ``merge``, ``expand`` at
   log_gap 8 (64 ciphertexts), every decrypted coefficient exact. The
   rings' engines checked (the CI ring on its plain transform, the
   others four-step); launch counts zeroed before the operations run once
   and read after, every distinct four-step call held against the plain
   version; per operation the ms (mean of 3) and its four-step launches;
   peak device memory; one ``complex_to_real`` profiled. 9b at
   ``N15QP768_H192_H32``, full logN 15, set up by ``prepare_recipe`` with
   the pack tree's Galois keys added: ``bootstrap_many`` of 4 ciphertexts
   of 2^12 slots packed into one bootstrap, and
   ``evaluate_conjugate_invariant`` of two CI ciphertexts on the chain's
   CI twin at logN 14 (16384 real slots, its own secret and ring-swap
   keys); every output at worst >= 11.8 / mean >= 14.0 bits (phase 7's
   floor less a bit), at or above the output level, with 0 kernel
   launches (rings Q and P mxu64-plain, the CI ring ci-plain); ms of pack,
   the bootstrap, unpack and the CI pair; peak device memory;
10. keys on the wire, every earlier phase's tensors freed and the peak
   memory counter reset. 10a on BGV ``bgv_tpu_params(14, 438)``: a client
   makes its keys; the server rebuilds equal parameters from the client's
   ``ParametersLiteral.to_json()`` and reads the relinearization key and
   the Galois key of rotate_columns(1) from Lattigo's bytes
   (``utils.lattigo_wire``); 4 + 4 ciphertexts go to the server as bytes,
   ``rotate_columns(rescale(mul_relin(a, b)), 1)`` runs there and 4
   results come back as bytes, decoded and checked against numpy's roll of
   a*b mod T in every slot. 10b: the same 13 Q primes with no P and with
   its first P prime, each with a base-2^14 relinearization key and an
   evaluation key sk -> sk2 sent as bytes; a batch of 4 through
   ``rescale(mul_relin)`` and one ``apply_evaluation_key``, both exact,
   and ``log2_noise_std`` fresh and after each key switch beside
   ``noise_fresh_sk``. 10c: a CKKS request at ``ckks_tpu_params(14, 438)``,
   ``rotate(rescale(mul_relin(a, b)), 1)`` over the wire, decoded equal
   before and after with its level, domain and scale kept, its
   evaluation-key set through ``utils.serialization`` and back onto the
   card. Every object sent is read back bit-equal and its size held to
   Lattigo's layout; per kind of object its bytes, write and read ms and
   MB/s; the request's ms end to end; the rings' engines checked
   (four-step everywhere); launch counts zeroed before the main path and
   read after, every distinct four-step call (the base-2 digit NTTs
   included) held against the plain version; peak device memory;
11. the reference's digit-matmul routes, every earlier phase's tensors
   freed and the peak memory counter reset. 11a the u64 four-step engine
   (``ring/ntt_u64_mxu.py``) on three chains: the bootstrap preset's 17
   primes at logN 15 (4 x 17 x 32768), the flagship's 3 40-bit primes at
   logN 12 (2 x 3 x 4096) and 4 61-bit primes below 2^61 at logN 16 (2 x 4
   x 65536), on inputs at the top of its contract (uniform in [0, 2q),
   some coefficients 2q - 1): forward and inverse, lazy (mod q, and below
   2q) and not, equal to the radix-2 engine; ntt_single and intt_single
   at limb 1 equal too; NTT then INTT the identity mod q; its two
   contractions (int8 ``torch._int_mm`` per limb, batched float64 matmul)
   equal; per chain the CUDA-event ms of both engines and both
   contractions, the dispatched torch ops per call, the bound, the
   tables' MiB and their cold host build time, and the working memory of
   one call. 11b the ModUp digit-matmul contraction on
   ``bgv_tpu_params(14, 438)``: the decode's Q -> T conversion (4 x 12 x
   16384) and Q -> P at full level (4 x 13 x 16384), equal to the raw
   multiply-accumulate, each timed both ways, and its calls on phase 3's
   and phase 6's main paths. 11c the native XOF against the hashlib loop:
   the 15-limb logN-14 CRP of phase 6's public-key seed, equal, host ms of
   each;
12. scale-out, every rank a process (``lattigo_tpu_torch.parallel.launch``)
   and 4 ranks sharing the one card over gloo, every exchange copied
   through the host: 12a the coefficient-sharded NTT at logN 16 on 11a's
   4 primes below 2^61, 2 polynomials, D = 4: forward, inverse (lazy and
   not) and ``negacyclic_mul_sharded``, bit-equal on every rank to the
   one-process ring (lazy mod q), ms of both (CUDA events, max over ranks),
   bytes swapped and staged; 12b phase 3's step on a dp 2 x limb 2 mesh,
   inputs a batch of 4 at 12 Q limbs and the keys made once here and sent
   to every rank (digests compared): the gathered output bit-equal to
   phase 3's evaluator in this process and a*b mod T in every slot; each
   rank's four-step launches (a ring over its own moduli), every distinct
   call held against the plain version; step ms (max over ranks, after a
   warm-up) beside the one-process step, bytes a rank receives and stages,
   peak memory a rank; 12c hoisted rotations [1, 3] at
   ``ckks_tpu_params(14, 438)`` over limb 2, the same checks; 12d
   ``dryrun_multichip(4, device="cuda", backend="gloo")``, the JAX dry
   run's four parts at its shapes;
13. the 16 examples (``lattigo_tpu_torch/examples``), each ``main()`` on the
   card with the JAX test's arguments: ms, the rings' NTT engines, the
   kernels' launches, every distinct kernel call held against the plain
   version; any failed assert fails the run;
14. the card's name and power limit as nvidia-smi gives them, the
   kernels' JSON line (the launches of phases 12 and 13 in
   ``scale_out_launches`` and ``examples_launches``), and the result line.

Needs one CUDA card, ``nvcc`` and the repository beside this file; imports
nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import math
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
# the circuits phase: the BGV polynomial of tests/test_bgv_polynomial.py;
# sign on ±[2^-8, 1] as 10 X4 stages: a Remez composite's later stages read
# T_k outside [-1, 1] and lose every bit at logN 14, at scale 2^28 and at
# 2^34; the full-domain inverse on the published N14 chain (q0 45 bits,
# scale 2^34): on the 28-bit chain q0 ≈ Δ = 2^28, and Goldschmidt's
# 1/x (mean ~3) wraps at level 0; its SK bootstrapper reports minimum
# input level 1, because the inverse multiplies by the sign without
# bootstrapping it, so the sign must end above level 0
CIRC_POLY7 = [12, 7, 0, 3, 0, 0, 1, 9]
CIRC_ALPHA = 8
CIRC_X4_STAGES = 10
CIRC_INV_MIN_LEVEL = 1
CIRC_INV_PRESET = "CKKS_COMPLEX_PARAMS_N14_QP438"
# floors (worst, mean bits): the JAX package on the same parameters, flow
# and inputs on the CPU (python tests/test_torch_comparison_inverse.py:
# step 11.07 / 14.64, max 9.31 / 10.84, Goldschmidt 10.45 / 14.90, inverse
# 16.38 / 21.08) less one bit
CIRC_MIN_BITS = {"step": (10.06, 13.63), "max": (8.31, 9.83),
                 "goldschmidt": (9.44, 13.89), "inverse full domain": (15.38, 20.07)}
# phase 9a: the CI twin of ckks_tpu_params(14, 438) (its primes at logN 13,
# 8192 real slots) and ring packing on its standard rings at logN 14 / 13:
# coefficients m * 2^32 with m in [-7, 7], expand keeps every 2^8-th
# coefficient (64 ciphertexts), extract takes 2 x 4 indices a quarter ring
# apart; floors (min, avg bits): the JAX package on the same parameters,
# flow and inputs on the CPU (python tests/test_torch_bridge.py, logN 14:
# CI request 10.48 / 13.84, complex_to_real 10.85 / 14.27, real_to_complex
# 10.72 / 13.59) less one bit
RP_DELTA = 1 << 32
RP_LOG_GAP = 8
RING_MIN_BITS = {"ci request": (9.48, 12.84), "complex_to_real": (9.85, 13.27),
                 "real_to_complex": (9.72, 12.59)}
# phase 9b: 4 sparse ciphertexts of 2^(logN - 3) slots share one bootstrap
# (g = 2); the floor (worst, mean bits) is phase 7's less one bit
SPARSE_G = 2
BTP9_MIN_BITS = (11.8, 14.0)
# phase 10: the base-2 gadget's digit width (tests/test_base2_gadget.py's):
# 2 digits a 28-bit limb
WIRE_BASE2 = 14
# phase 11: the ModUp digit-matmul contractions on phase 3's and phase 6's
# main paths, counted there
MODUP_MXU_CALLS: dict[str, int] = {}
# phase 7 with its rings on the radix-2 engine (one H100 80GB HBM3 at
# 700 W, before the u64 four-step engine took them): dispatched torch ops
# per bootstrap, their share inside the NTT engine, its calls
BTP_RADIX2_OPS = (432089, 0.767, 317)


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
    logs = build.build(["ntt_mxu", "ntt_pallas", "xof"])
    secs = time.perf_counter() - t0
    regs = sorted({ln.split("Used ")[1].split(",")[0] for log in logs.values()
                   for ln in log.splitlines() if "Used " in ln})
    print(f"phase 1 build: ntt_mxu.cu, ntt_pallas.cu (nvcc) and xof.cpp (g++) "
          f"in {secs:.2f} s (ptxas: {'; '.join(regs)})")


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


def count_calls(module, name: str, fn):
    """Run fn() with ``module.name`` counting its calls: (fn's result, the
    count)."""
    target = getattr(module, name)
    n = [0]

    def counting(*args, **kwargs):
        n[0] += 1
        return target(*args, **kwargs)

    setattr(module, name, counting)
    try:
        out = fn()
    finally:
        setattr(module, name, target)
    return out, n[0]


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
    from lattigo_tpu_torch.ring import basis_extension, ntt_mxu

    t0 = time.perf_counter()
    params, a, b, serve, step_of = bgv_server()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ((ca, cb, got), calls, launches), MODUP_MXU_CALLS["phase 3"] = count_calls(
        basis_extension, "_mod_up_contract_mxu",
        lambda: record_calls(ntt_mxu, "four_step_cuda", serve))
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
          f"{launches} (ModUp digit-matmul contractions "
          f"{MODUP_MXU_CALLS['phase 3']}), per step "
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
    from lattigo_tpu_torch.ring import basis_extension, ntt_mxu

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
    (res, calls, launches), MODUP_MXU_CALLS["phase 6"] = count_calls(
        basis_extension, "_mod_up_contract_mxu", lambda: record_calls(
            ntt_mxu, "four_step_cuda", lambda: mp_flow("cuda", LOG_N, LOG_QP, timed)))
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
          f"{len(calls)} distinct calls; launches on the run {launches} (ModUp "
          f"digit-matmul contractions {MODUP_MXU_CALLS['phase 6']}); CRPs "
          f"{crp_ms:.1f} ms on the host (native XOF) in {stats['crp'][3]} "
          f"samplings; step "
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
    those dispatched inside an NTT engine of library code (the plain
    radix-2 NTT / INTT, the u64 four-step engine), and that engine's calls
    by name ("radix2", "mxu64")."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from lattigo_tpu_torch.ring import ntt as ntt_mod, ntt_u64_mxu
        counter = self
        self.total = self.in_ntt = 0
        self.calls = {"radix2": 0, "mxu64": 0}
        self._depth = 0
        self._targets = [(ntt_mod, "ntt", "radix2"), (ntt_mod, "intt", "radix2"),
                         (ntt_u64_mxu.NTTMxu64, "_apply", "mxu64")]
        self._orig = [getattr(obj, name) for obj, name, _ in self._targets]

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.total += 1
                counter.in_ntt += counter._depth > 0
                return func(*args, **(kwargs or {}))

        self._mode = Mode()

    @property
    def ntt_calls(self) -> int:
        return sum(self.calls.values())

    def _wrap(self, fn, engine: str):
        def wrapped(*a, **kw):
            self.calls[engine] += 1
            self._depth += 1
            try:
                return fn(*a, **kw)
            finally:
                self._depth -= 1
        return wrapped

    def __enter__(self):
        for (obj, name, engine), fn in zip(self._targets, self._orig):
            setattr(obj, name, self._wrap(fn, engine))
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        for (obj, name, _), fn in zip(self._targets, self._orig):
            setattr(obj, name, fn)


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
        check(eng == "mxu64-plain", f"bootstrap ring {name} on {eng}")
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
          f"a kernel launched on the mxu64-plain bootstrap: {launches}")
    check(ops.calls["radix2"] == 0 and ops.calls["mxu64"] > 0,
          f"the bootstrap's NTT calls {ops.calls}: radix-2 ran on mxu64 rings")
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
          f"{ops.in_ntt} ({ops.in_ntt / ops.total:.3f}) inside the NTT engine's "
          f"{ops.ntt_calls} calls {ops.calls} (on radix2-plain rings: "
          f"{BTP_RADIX2_OPS[0]} ops, {BTP_RADIX2_OPS[1]} inside {BTP_RADIX2_OPS[2]} "
          f"radix-2 calls); peak device memory {peak_mb:.1f} MiB "
          f"({keys_mb:.1f} over the set-up, {resident_mb:.1f} resident after it; "
          f"{held_mb:.1f} held by earlier phases at the start); the phase "
          f"{phase_s:.1f} s")
    ct_re = marks["c2s re"][1]
    print("phase 7 profile (one EvalMod half): "
          + profile_families(lambda: btp.eval_mod(ct_re)))


def circuits_inputs(bgv_n: int, t: int, slots: int, inv_slots: int) -> dict:
    """Phase 8's seeded numpy inputs, in one draw order (the JAX package's
    floor run in ``tests/test_torch_comparison_inverse.py`` reads them
    too): BGV messages mod t (BATCH x bgv_n, twice), the degree-31
    coefficients, step's x ∈ ±[2^-8, 1], max's a ∈ [-1/2, 1/2] and b = a − d
    with d ∈ ±[2^-8, 1], Goldschmidt's x ∈ [2^-4, 1] and the inverse's
    x ∈ ±[2^-3, 2^2]."""
    import numpy as np
    rng = np.random.default_rng(SEED)

    def signed(lo, hi, n):
        return rng.uniform(lo, hi, n) * rng.choice([-1.0, 1.0], n)

    m1 = rng.integers(0, t, (BATCH, bgv_n))
    m2 = rng.integers(0, t, (BATCH, bgv_n))
    poly31 = [int(c) for c in rng.integers(0, t, 32)]
    step_x = signed(2.0 ** -CIRC_ALPHA, 1.0, slots)
    max_a = rng.uniform(-0.5, 0.5, slots)
    max_b = max_a - signed(2.0 ** -CIRC_ALPHA, 1.0, slots)
    gold_x = rng.uniform(2.0 ** -4, 1.0, slots)
    inv_x = signed(2.0 ** -3, 2.0 ** 2, inv_slots)
    return dict(m1=m1, m2=m2, poly31=poly31, step_x=step_x, max_a=max_a,
                max_b=max_b, gold_x=gold_x, inv_x=inv_x)


def circuits_flow(device, log_n: int = LOG_N):
    """Phase 8's circuits on ``device`` (logN cut to ``log_n`` for a
    rehearsal on the CPU): the parameters, keys (each set from its own
    generator), SK bootstrappers and input ciphertexts of 8a and 8b, and
    ``circuits``: {name: (run, check, input level, bootstrapper or None)},
    where run() evaluates the circuit on its encrypted inputs and check(out)
    returns True (8a, exact) or the (worst, mean) bits (8b)."""
    import dataclasses
    import numpy as np
    import torch
    from lattigo_tpu_torch import presets, rlwe
    from lattigo_tpu_torch.circuits.bgv_polynomial import BGVPolynomialEvaluator
    from lattigo_tpu_torch.circuits.bootstrapping import SecretKeyBootstrapper
    from lattigo_tpu_torch.circuits.bootstrapping_presets import precision_bits
    from lattigo_tpu_torch.circuits.comparison import ComparisonEvaluator
    from lattigo_tpu_torch.circuits.inverse import InverseEvaluator
    from lattigo_tpu_torch.circuits.minimax import MinimaxCompositeEvaluator, SIGN_X4_CHEBY
    from lattigo_tpu_torch.schemes import bgv, ckks

    gens = [torch.Generator(device=device).manual_seed(SEED * 8 + i) for i in range(6)]
    bp = bgv.Parameters(presets.bgv_tpu_params(log_n, LOG_QP), device=device)
    cp = ckks.Parameters(presets.ckks_tpu_params(log_n, LOG_QP), device=device)
    ip = ckks.Parameters(dataclasses.replace(
        getattr(presets, CIRC_INV_PRESET), log_n=log_n), device=device)
    x = circuits_inputs(bp.n, bp.t, cp.max_slots, ip.max_slots)

    # 8a: BGV / BFV, a batch of BATCH
    kg = rlwe.KeyGenerator(bp)
    bsk = kg.gen_secret_key(gens[0])
    bev = bgv.Evaluator(bp, rlwe.EvaluationKeySet(kg.gen_relinearization_key(gens[0], bsk)))
    benc, bdec = bgv.Encoder(bp), rlwe.Decryptor(bp, bsk)
    encr = rlwe.Encryptor(bp, bsk)
    c1, c2 = (encr.encrypt(gens[1], benc.encode(x[k]), batch=(BATCH,)) for k in ("m1", "m2"))
    pe = BGVPolynomialEvaluator(bev)
    t = bp.t
    o1, o2 = x["m1"].astype(object), x["m2"].astype(object)

    def horner(coeffs):
        acc = np.zeros(o1.shape, dtype=object)
        for c in coeffs[::-1]:
            acc = (acc * o1 + c) % t
        return acc

    def exact(want):
        return lambda out: bool(np.array_equal(benc.decode(bdec.decrypt(out)) % t,
                                               (want % t).astype(np.int64)))

    circuits = {
        "bgv poly7": (lambda: pe.evaluate(c1, CIRC_POLY7), exact(horner(CIRC_POLY7)),
                      c1.level, None),
        "bgv poly31": (lambda: pe.evaluate(c1, x["poly31"]), exact(horner(x["poly31"])),
                       c1.level, None),
        "bfv mul_scale_invariant x2": (
            lambda: bev.mul_scale_invariant(bev.mul_scale_invariant(c1, c2, relin=True),
                                            c1, relin=True),
            exact(o1 * o2 * o1), c1.level, None),
    }

    # 8b: CKKS on the four-step chain, secret-key bootstraps between stages
    def ckks_keys(params, gen, btp_gen, min_level):
        kg = rlwe.KeyGenerator(params)
        sk = kg.gen_secret_key(gen)
        ev = ckks.Evaluator(params, None)
        els = MinimaxCompositeEvaluator(ev).galois_elements()
        ev = ckks.Evaluator(params, rlwe.EvaluationKeySet(
            kg.gen_relinearization_key(gen, sk), kg.gen_galois_keys(gen, els, sk)))
        enc, dec = ckks.Encoder(params), rlwe.Decryptor(params, sk)
        btp = SecretKeyBootstrapper(params, enc, sk, btp_gen, minimum_input_level=min_level)
        encryptor = rlwe.Encryptor(params, sk)
        return (ev, btp, lambda v: encryptor.encrypt(gen, enc.encode(v)),
                lambda ct: enc.decode(dec.decrypt(ct)).real)

    cev, cbtp, cenc, cdec = ckks_keys(cp, gens[2], gens[3], 0)
    sign_polys = [SIGN_X4_CHEBY] * CIRC_X4_STAGES
    ce = ComparisonEvaluator(cev, sign_polys=sign_polys, bootstrapper=cbtp)
    ct_step = cenc(x["step_x"])
    ct_a, ct_b = cenc(x["max_a"]), cenc(x["max_b"])
    ct_gold = cenc(x["gold_x"])

    def rel(v):
        return lambda out: precision_bits(cdec(out) * v, 1.0)

    circuits["step"] = (lambda: ce.step(ct_step), lambda out: precision_bits(
        cdec(out), (np.sign(x["step_x"]) + 1) / 2), ct_step.level, cbtp)
    circuits["max"] = (lambda: ce.max(ct_a, ct_b), lambda out: precision_bits(
        cdec(out), np.maximum(x["max_a"], x["max_b"])), ct_a.level, cbtp)
    circuits["goldschmidt"] = (
        lambda: InverseEvaluator(cev, bootstrapper=cbtp).goldschmidt_division(
            ct_gold, log2min=-4.0), rel(x["gold_x"]), ct_gold.level, cbtp)

    # 8b: the full-domain inverse needs level 0 to hold 1/x: the published
    # chain, whose q0 (45 bits) is 2^11 above its scale; its sign must end
    # above level 0, where the inverse multiplies by it again
    iev, ibtp, ienc, idec = ckks_keys(ip, gens[4], gens[5], CIRC_INV_MIN_LEVEL)
    ie = InverseEvaluator(iev, bootstrapper=ibtp, sign_polys=sign_polys)
    ct_inv = ienc(x["inv_x"])
    circuits["inverse full domain"] = (
        lambda: ie.evaluate_full_domain(ct_inv, -3.0, 2.0),
        lambda out: precision_bits(idec(out) * x["inv_x"], 1.0), ct_inv.level, ibtp)

    return dict(bgv=bp, ckks=cp, inv=ip, circuits=circuits, ckks_ev=cev,
                stage_input=ct_step)


def phase_circuits(rows, log_n: int = LOG_N):
    import numpy as np
    import torch
    from lattigo_tpu_torch.circuits.minimax import MinimaxCompositeEvaluator, SIGN_X4_CHEBY
    from lattigo_tpu_torch.ring import ntt_mxu, ntt_pallas

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    res = circuits_flow("cuda", log_n)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    bp, cp, ip, circuits = res["bgv"], res["ckks"], res["inv"], res["circuits"]
    engines = {"BGV Q": bp.ring_q, "BGV P": bp.ring_p, "BGV T": bp.ring_t,
               "BFV QMul": bp.ring_qmul, "CKKS Q": cp.ring_q, "CKKS P": cp.ring_p,
               "inverse Q": ip.ring_q, "inverse P": ip.ring_p}
    engines = {k: r.ntt_engine for k, r in engines.items()}
    for k, eng in engines.items():
        # QMul's 61-bit primes lie just above 2^61, off the u64 four-step
        # engine's range (the reference's rule too): radix-2
        want = {"BFV QMul": "radix2-plain", "inverse Q": "mxu64-plain",
                "inverse P": "mxu64-plain"}.get(k, "mxu-cuda")
        check(eng == want, f"phase 8 ring {k} on {eng}, not {want}")

    # the main path once: every circuit, the four-step calls recorded
    def main_path():
        return {name: run() for name, (run, _, _, _) in circuits.items()}

    ntt_pallas.reset_launches()
    outs, calls, launches = record_calls(ntt_mxu, "four_step_cuda", main_path)
    check(all(v == 0 for v in ntt_pallas.LAUNCHES.values()),
          f"the u32 kernel launched in phase 8: {ntt_pallas.LAUNCHES}")
    results = {}
    for name, (_, chk, _, _) in circuits.items():
        results[name] = chk(outs[name])
        if name.startswith(("bgv", "bfv")):
            check(results[name] is True, f"{name}: decoded slots != numpy mod T")
        else:
            floor = CIRC_MIN_BITS[name]
            worst, mean = results[name]
            check(worst >= floor[0] and mean >= floor[1],
                  f"{name}: worst {worst:.2f} / mean {mean:.2f} bits below the "
                  f"floor {floor[0]} / {floor[1]}")
    check(outs["bfv mul_scale_invariant x2"].level == circuits[
        "bfv mul_scale_invariant x2"][2], "mul_scale_invariant changed the level")
    mxu_rows = [r for r in rows if r["name"].startswith("ntt_mxu")]
    for r in rows:
        counts = launches if r["name"].startswith("ntt_mxu") else ntt_pallas.LAUNCHES
        r["circuits_launches"] = counts["inverse" if r["name"].endswith("inverse")
                                        else "forward"]
    for r in mxu_rows:
        check(r["circuits_launches"] > 0, f"{r['name']} not launched in phase 8")
    launch = ntt_mxu.four_step_cuda
    for eng, xin, limb_lo, inverse, lazy in calls.values():
        k = launch(eng, xin, limb_lo, inverse, lazy)
        want_k = ntt_mxu.four_step_plain(eng, xin, limb_lo, inverse, lazy)
        for r in mxu_rows:
            if r["name"].endswith("inverse") == inverse:
                r["max_abs_err"] = max(r["max_abs_err"], int((k - want_k).abs().max()))
        check(torch.equal(k, want_k), f"kernel != plain at phase-8 call "
              f"{tuple(xin.shape)} limb_lo={limb_lo} inverse={inverse}")

    # per circuit: launches, bootstraps and levels of one run, then the mean
    # of 3 runs after it (the recorded run was the warm-up)
    stats = {}
    for name, (run, _, level_in, btp) in circuits.items():
        b0 = btp.counter if btp is not None else 0
        ntt_mxu.reset_launches()
        torch.cuda.synchronize()
        out = run()
        torch.cuda.synchronize()
        lau = dict(ntt_mxu.LAUNCHES)
        boots = (btp.counter - b0) if btp is not None else 0
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        stats[name] = ((time.perf_counter() - t0) / 3 * 1e3, boots, level_in,
                       out.level, lau)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    phase_s = time.perf_counter() - t_phase

    def bits(name):
        r = results[name]
        return "exact" if r is True else f"{r[0]:.2f} / {r[1]:.2f} bits"

    print(f"phase 8 circuits: 8a BGV logN={bp.log_n} Q={len(bp.q_moduli)}x28-bit "
          f"T={bp.t}, {BATCH} ciphertexts, BFV QMul {len(bp.ring_qmul.moduli)} primes "
          f"of 61-62 bits; 8b CKKS logN={cp.log_n} Q={len(cp.q_moduli)}x28-bit scale "
          f"2^{cp.log_default_scale}, sign = {CIRC_X4_STAGES} X4 stages, SK "
          f"bootstrapper; inverse on "
          f"{CIRC_INV_PRESET} (Q {[q.bit_length() for q in ip.q_moduli]}, scale "
          f"2^{ip.log_default_scale}) with the same sign, SK bootstrapper at minimum "
          f"input level {CIRC_INV_MIN_LEVEL}; engines {engines}; set-up {setup_s:.2f} s; results: "
          + ", ".join(f"{k} {bits(k)}" for k in circuits)
          + f" (floors worst / mean: {CIRC_MIN_BITS}); four-step bit-equal to plain at "
          f"the {len(calls)} distinct calls; launches on the main path {launches}; "
          f"peak device memory {peak_mb:.1f} MiB; the phase {phase_s:.1f} s")
    print("phase 8 per circuit (ms mean of 3 after one warm-up [SK bootstraps, "
          "level in -> out, four-step forward/inverse launches]): " + "; ".join(
              f"{k} {ms:.1f} ms [{b}, {li} -> {lo}, {lau['forward']}/{lau['inverse']}]"
              for k, (ms, b, li, lo, lau) in stats.items()))
    mce = MinimaxCompositeEvaluator(res["ckks_ev"])
    ct = res["stage_input"]
    print("phase 8 profile (one X4 composite stage at level "
          f"{ct.level}, logN {cp.log_n}): "
          + profile_families(lambda: mce.evaluate(ct, [SIGN_X4_CHEBY])))


def ring_inputs(n_ci: int, slots: int) -> dict:
    """Phase 9a's seeded numpy inputs, in one draw order (the JAX package's
    floor run in ``tests/test_torch_bridge.py`` reads them too): the CI
    request's a and b (BATCH x n_ci reals in [-1, 1)), the bridge's BATCH x
    slots complex values and the ring-packing message (2 n_ci coefficients
    in [-7, 7])."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    a = rng.uniform(-1, 1, (BATCH, n_ci))
    b = rng.uniform(-1, 1, (BATCH, n_ci))
    z = rng.uniform(-1, 1, (BATCH, slots)) + 1j * rng.uniform(-1, 1, (BATCH, slots))
    m = rng.integers(-7, 8, 2 * n_ci)
    return dict(a=a, b=b, z=z, m=m)


def wire_inputs(n: int, t: int, slots: int) -> dict:
    """Phase 10's seeded numpy inputs, in one draw order (the JAX package's
    precision run in ``tests/test_torch_wire.py`` reads them too): the BGV
    request's a and b (BATCH x n in [0, t)), then the CKKS request's za and
    zb (BATCH x slots complex values in [-1, 1) + [-1, 1)i)."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    a = rng.integers(0, t, (BATCH, n))
    b = rng.integers(0, t, (BATCH, n))
    za = rng.uniform(-1, 1, (BATCH, slots)) + 1j * rng.uniform(-1, 1, (BATCH, slots))
    zb = rng.uniform(-1, 1, (BATCH, slots)) + 1j * rng.uniform(-1, 1, (BATCH, slots))
    return dict(a=a, b=b, za=za, zb=zb)


def exact_coeffs(params, sk, ct) -> "np.ndarray":
    """The decrypted coefficients of ct (one polynomial or a batch) over
    RP_DELTA, rounded: centred from the first two limbs by CRT, which holds
    every |m| * 2^32 + noise below q0 q1 / 2 ~ 2^55 exactly."""
    import numpy as np
    from lattigo_tpu_torch import rlwe
    pt = rlwe.Decryptor(params, sk).decrypt(ct.at_level(1))
    r = params.ring_q.intt(pt.value, 1).cpu().numpy()
    q0, q1 = params.q_moduli[:2]
    t = (r[..., 1, :] - r[..., 0, :]) % q1 * pow(q0, -1, q1) % q1
    x = r[..., 0, :] + q0 * t
    x = np.where(x > q0 * q1 // 2, x - q0 * q1, x)
    return np.round(x / RP_DELTA).astype(np.int64)


def ring_flow(device, log_n: int = LOG_N):
    """Phase 9a on ``device`` (logN cut to ``log_n`` for a rehearsal on the
    CPU): ``ckks_tpu_params(log_n, LOG_QP)``, its CI twin and its standard
    ring at log_n - 1 on the same primes, their keys (each set from its own
    generator) and inputs, and ``ops``: {name: (run, check)}, where run()
    evaluates one operation and check(out) returns (min, avg) bits (CKKS)
    or True (exact ring packing)."""
    import dataclasses
    import numpy as np
    import torch
    from lattigo_tpu_torch import presets, rlwe
    from lattigo_tpu_torch.ring.ring import CONJUGATE_INVARIANT, STANDARD
    from lattigo_tpu_torch.rlwe.ring_packing import (
        RingPackingEvaluator, gen_ring_switching_keys)
    from lattigo_tpu_torch.schemes import ckks
    from lattigo_tpu_torch.schemes.ckks.bridge import DomainSwitcher, gen_ring_swap_keys

    gens = [torch.Generator(device=device).manual_seed(SEED * 9 + i) for i in range(6)]
    p_std = ckks.Parameters(presets.ckks_tpu_params(log_n, LOG_QP), device=device)
    half = dataclasses.replace(
        p_std.literal, log_n=log_n - 1, q=tuple(p_std.q_moduli), p=tuple(p_std.p_moduli),
        log_q=None, log_p=None)
    p_ci = ckks.Parameters(dataclasses.replace(half, ring_type=CONJUGATE_INVARIANT), device)
    p_half = ckks.Parameters(dataclasses.replace(half, ring_type=STANDARD), device)
    x = ring_inputs(p_ci.n, p_std.max_slots)

    # the CI request: rotate(rescale(mul_relin(a, b)), 1) on BATCH real vectors
    kg_ci = rlwe.KeyGenerator(p_ci)
    sk_ci = kg_ci.gen_secret_key(gens[0])
    ev_ci = ckks.Evaluator(p_ci, rlwe.EvaluationKeySet(
        kg_ci.gen_relinearization_key(gens[0], sk_ci),
        kg_ci.gen_galois_keys(gens[0], [p_ci.galois_element(1)], sk_ci)))
    enc_ci, dec_ci = ckks.CIEncoder(p_ci), rlwe.Decryptor(p_ci, sk_ci)
    encr_ci = rlwe.Encryptor(p_ci, sk_ci)
    ca, cb = (encr_ci.encrypt(gens[1], enc_ci.encode(x[k]), batch=(BATCH,)) for k in "ab")

    # the domain switcher between logN and its CI twin
    kg = rlwe.KeyGenerator(p_std)
    sk_std = kg.gen_secret_key(gens[2])
    sw = DomainSwitcher(p_std, p_ci, *gen_ring_swap_keys(gens[2], p_std, sk_std, sk_ci))
    enc_std = ckks.Encoder(p_std)
    cz = rlwe.Encryptor(p_std, sk_std).encrypt(gens[3], enc_std.encode(x["z"]), batch=(BATCH,))
    down = sw.complex_to_real(cz)

    # ring packing on the standard rings at logN and logN - 1
    sk_half = rlwe.KeyGenerator(p_half).gen_secret_key(gens[4])
    params = {log_n - 1: p_half, log_n: p_std}
    sks = {log_n - 1: sk_half, log_n: sk_std}
    switching = gen_ring_switching_keys(gens[4], params, sks)
    evs = {}
    for l, p in params.items():
        rp0 = RingPackingEvaluator(rlwe.Evaluator(p))
        els = set(rp0.galois_elements_for_expand())
        if l == log_n - 1:
            els |= set(rp0.galois_elements_for_pack())
        evs[l] = rlwe.Evaluator(p, rlwe.EvaluationKeySet(
            galois_keys=rlwe.KeyGenerator(p).gen_galois_keys(gens[5], sorted(els), sks[l])))
    rp = RingPackingEvaluator(evs[log_n], switching=switching, evaluators=evs)
    m = x["m"]
    rq = p_std.ring_q
    ct_m = rlwe.Encryptor(p_std, sk_std).encrypt(gens[5], rlwe.Plaintext(
        value=rq.ntt(rq.from_int_coeffs([int(c) * RP_DELTA for c in m])), is_ntt=True))
    quarter = p_std.n // 4
    idx = [r + k * quarter for r in (0, 1) for k in range(4)]

    def bits(got, want):
        from lattigo_tpu_torch.schemes.ckks import get_precision_stats
        check(got.shape == want.shape and bool(np.isfinite(got).all()),
              f"decoded slots of shape {got.shape}, not all finite")
        st = get_precision_stats(want, got)
        return st.min_precision, st.avg_precision

    def extract_repack():
        cts = rp.extract(ct_m, idx)
        return cts, rp.repack(cts)

    def check_extract(out):
        cts, back = out
        want = np.where(np.isin(np.arange(p_std.n), idx), m, 0)
        return (sorted(cts) == sorted(idx)
                and all(c.n == p_half.n and exact_coeffs(p_half, sk_half, c)[0] == m[i]
                        for i, c in cts.items())
                and bool(np.array_equal(exact_coeffs(p_std, sk_std, back), want)))

    def split_merge():
        even, odd = rp.split(ct_m)
        return even, odd, rp.merge(even, odd)

    def check_split(out):
        even, odd, back = out
        return (bool(np.array_equal(exact_coeffs(p_half, sk_half, even), m[0::2]))
                and bool(np.array_equal(exact_coeffs(p_half, sk_half, odd), m[1::2]))
                and bool(np.array_equal(exact_coeffs(p_std, sk_std, back), m)))

    def check_expand(out):
        gap = 1 << RP_LOG_GAP
        return (sorted(out) == list(range(0, p_std.n, gap))
                and all(exact_coeffs(p_std, sk_std, c)[0] == m[i] for i, c in out.items()))

    ops = {
        "ci request": (lambda: ev_ci.rotate(ev_ci.rescale(ev_ci.mul_relin(ca, cb)), 1),
                       lambda out: bits(enc_ci.decode(dec_ci.decrypt(out)),
                                        np.roll(x["a"] * x["b"], -1, axis=-1))),
        "complex_to_real": (lambda: sw.complex_to_real(cz),
                            lambda out: bits(enc_ci.decode(dec_ci.decrypt(out)), x["z"].real)),
        "real_to_complex": (lambda: sw.real_to_complex(down),
                            lambda out: bits(enc_std.decode(rlwe.Decryptor(
                                p_std, sk_std).decrypt(out)), x["z"].real + 0j)),
        "extract+repack": (extract_repack, check_extract),
        "split+merge": (split_merge, check_split),
        "expand": (lambda: rp.expand(ct_m, RP_LOG_GAP), check_expand),
    }
    return dict(std=p_std, ci=p_ci, half=p_half, ops=ops, cz=cz, sw=sw,
                scale_in=cz.scale, scale_down=down.scale, galois_keys={
                    l: len(e.evk.galois_keys) for l, e in evs.items()})


def phase_ring_packing(rows, log_n: int = LOG_N):
    import torch
    from lattigo_tpu_torch.ring import ntt_mxu, ntt_pallas

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    res = ring_flow("cuda", log_n)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    keys_mb = torch.cuda.max_memory_allocated() / 2**20
    ops = res["ops"]
    engines = {"std Q": res["std"].ring_q, "std P": res["std"].ring_p,
               "CI Q": res["ci"].ring_q, "CI P": res["ci"].ring_p,
               "half Q": res["half"].ring_q, "half P": res["half"].ring_p}
    engines = {k: r.ntt_engine for k, r in engines.items()}
    for k, eng in engines.items():
        want = "ci-plain" if k.startswith("CI") else "mxu-cuda"
        check(eng == want, f"phase 9a ring {k} on {eng}, not {want}")
    check(res["scale_down"] == 2 * res["scale_in"], "complex_to_real did not double the scale")

    # the main path once: every operation, the four-step calls recorded
    def main_path():
        return {name: run() for name, (run, _) in ops.items()}

    ntt_pallas.reset_launches()
    outs, calls, launches = record_calls(ntt_mxu, "four_step_cuda", main_path)
    check(all(v == 0 for v in ntt_pallas.LAUNCHES.values()),
          f"the u32 kernel launched in phase 9a: {ntt_pallas.LAUNCHES}")
    results = {}
    for name, (_, chk) in ops.items():
        results[name] = chk(outs[name])
        if name in RING_MIN_BITS:
            floor = RING_MIN_BITS[name]
            lo, avg = results[name]
            check(lo >= floor[0] and avg >= floor[1],
                  f"{name}: min {lo:.2f} / avg {avg:.2f} bits below the floor "
                  f"{floor[0]} / {floor[1]}")
        else:
            check(results[name] is True, f"{name}: a decrypted coefficient is not exact")
    mxu_rows = [r for r in rows if r["name"].startswith("ntt_mxu")]
    for r in rows:
        counts = launches if r["name"].startswith("ntt_mxu") else ntt_pallas.LAUNCHES
        r["ring_launches"] = counts["inverse" if r["name"].endswith("inverse") else "forward"]
    for r in mxu_rows:
        check(r["ring_launches"] > 0, f"{r['name']} not launched in phase 9a")
    launch = ntt_mxu.four_step_cuda
    for eng, xin, limb_lo, inverse, lazy in calls.values():
        k = launch(eng, xin, limb_lo, inverse, lazy)
        want_k = ntt_mxu.four_step_plain(eng, xin, limb_lo, inverse, lazy)
        for r in mxu_rows:
            if r["name"].endswith("inverse") == inverse:
                r["max_abs_err"] = max(r["max_abs_err"], int((k - want_k).abs().max()))
        check(torch.equal(k, want_k), f"kernel != plain at phase-9a call "
              f"{tuple(xin.shape)} limb_lo={limb_lo} inverse={inverse}")

    # per operation: four-step launches of one run, then the mean of 3
    stats = {}
    for name, (run, _) in ops.items():
        ntt_mxu.reset_launches()
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
        lau = dict(ntt_mxu.LAUNCHES)
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        stats[name] = ((time.perf_counter() - t0) / 3 * 1e3, lau)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    phase_s = time.perf_counter() - t_phase

    def res_text(name):
        r = results[name]
        return "exact" if r is True else f"{r[0]:.2f} / {r[1]:.2f} bits"

    std, ci = res["std"], res["ci"]
    print(f"phase 9a rings: CKKS logN={std.log_n} Q={len(std.q_moduli)}x28-bit "
          f"P={len(std.p_moduli)}x28-bit scale 2^{std.log_default_scale}, its CI twin "
          f"logN={ci.log_n} ({ci.max_slots} real slots) and standard logN={ci.log_n} on the "
          f"same primes; engines {engines}; Galois keys by logN {res['galois_keys']}; "
          f"set-up {setup_s:.2f} s, peak memory after keys {keys_mb:.1f} MiB; {BATCH} "
          "requests; results: " + ", ".join(f"{k} {res_text(k)}" for k in ops)
          + f" (floors min / avg: {RING_MIN_BITS}); four-step bit-equal to plain at the "
          f"{len(calls)} distinct calls; launches on the main path {launches}; peak "
          f"device memory {peak_mb:.1f} MiB; the phase {phase_s:.1f} s")
    print("phase 9a per operation (ms mean of 3 after the main path [four-step "
          "forward/inverse launches]): " + "; ".join(
              f"{k} {ms:.1f} ms [{lau['forward']}/{lau['inverse']}]"
              for k, (ms, lau) in stats.items()))
    cz, sw = res["cz"], res["sw"]
    print(f"phase 9a profile (one complex_to_real of {BATCH}): "
          + profile_families(lambda: sw.complex_to_real(cz)))


def sparse_bootstrap_flow(device, log_n: int | None, timed):
    """Phase 9b's main path at ``BTP_PRESET`` (its logN cut to ``log_n``
    when given, for a rehearsal on the CPU), set up by ``prepare_recipe``
    with the pack tree's Galois keys added: 4 sparse ciphertexts of
    2^(logN - 1 - SPARSE_G) slots and, on the chain's CI twin at logN - 1
    with its own secret and ring-swap keys, 2 CI ciphertexts, all at the
    minimum input level. Returns the objects, ``sparse(on_boot)`` and
    ``ci()`` (the two entry points; ``on_boot(phase)`` sees "pack" before
    the bootstrap and "boot" after it) and their checks, each giving the
    (worst, mean) bits of every output."""
    import dataclasses
    import numpy as np
    import torch
    from lattigo_tpu_torch import rlwe
    from lattigo_tpu_torch.circuits import bootstrapping_presets as bp
    from lattigo_tpu_torch.ring.ring import CONJUGATE_INVARIANT
    from lattigo_tpu_torch.schemes import ckks
    from lattigo_tpu_torch.schemes.ckks.bridge import DomainSwitcher, gen_ring_swap_keys

    preset = getattr(bp, BTP_PRESET)
    log_slots = (log_n or preset[0].log_n) - 1 - SPARSE_G
    r = bp.prepare_recipe(preset, log_n=log_n, seed=SEED, data_seed=SEED, device=device,
                          timed=timed, pack_log_slots=log_slots)
    params, btp, keys, sk = r["params"], r["evaluator"], r["keys"], r["sk"]
    gen = torch.Generator(device=device).manual_seed(SEED * 11)
    ci_lit = dataclasses.replace(params.literal, log_n=params.log_n - 1,
                                 q=tuple(params.q_moduli), p=tuple(params.p_moduli),
                                 log_q=None, log_p=None, ring_type=CONJUGATE_INVARIANT)
    p_ci = timed("CI twin", lambda: ckks.Parameters(ci_lit, device))
    sk_ci = rlwe.KeyGenerator(p_ci).gen_secret_key(gen)
    sw = DomainSwitcher(params, p_ci, *timed(
        "ring-swap keys", lambda: gen_ring_swap_keys(gen, params, sk, sk_ci)))
    rng = np.random.default_rng(SEED + 9)
    n_small = 1 << log_slots
    sparse = [np.tile(rng.uniform(-1, 1, n_small) + 1j * rng.uniform(-1, 1, n_small),
                      params.max_slots // n_small) for _ in range(1 << SPARSE_G)]
    reals = [rng.uniform(-1, 1, p_ci.max_slots) for _ in range(2)]
    enc, enc_ci = ckks.Encoder(params), ckks.CIEncoder(p_ci)
    level = btp.minimum_input_level
    cts = [rlwe.Encryptor(params, sk).encrypt(gen, enc.encode(v)).at_level(level)
           for v in sparse]
    cts_ci = [rlwe.Encryptor(p_ci, sk_ci).encrypt(gen, enc_ci.encode(v)).at_level(level)
              for v in reals]
    dec, dec_ci = rlwe.Decryptor(params, sk), rlwe.Decryptor(p_ci, sk_ci)

    def sparse_run(on_boot=None):
        if on_boot is None:
            return btp.bootstrap_many(cts, keys, log_slots=log_slots)
        boot = btp.bootstrap

        def timed_boot(ct, k=None):
            on_boot("pack")
            out = boot(ct, k)
            on_boot("boot")
            return out

        btp.bootstrap = timed_boot
        try:
            return btp.bootstrap_many(cts, keys, log_slots=log_slots)
        finally:
            del btp.bootstrap

    def levels_ok(outs):
        return all(o.level >= btp.output_level for o in outs)

    def sparse_bits(outs):
        check(len(outs) == len(sparse) and levels_ok(outs), "sparse outputs below "
              f"the output level {btp.output_level}")
        return [bp.precision_bits(enc.decode(dec.decrypt(o)), v) for o, v in zip(outs, sparse)]

    def ci_bits(outs):
        check(levels_ok(outs) and all(o.n == p_ci.n for o in outs),
              "CI outputs not on the CI ring at the output level")
        return [bp.precision_bits(enc_ci.decode(dec_ci.decrypt(o)), v)
                for o, v in zip(outs, reals)]

    return dict(params=params, ci=p_ci, btp=btp, log_slots=log_slots,
                sparse=sparse_run, sparse_bits=sparse_bits,
                ci_pair=lambda: btp.evaluate_conjugate_invariant(
                    *cts_ci, switcher=sw, keys=keys), ci_bits=ci_bits,
                galois_keys=len(r["galois_keys"]))


def phase_sparse_bootstrap(rows, log_n: int | None = None):
    import torch
    from lattigo_tpu_torch.ring import ntt_mxu, ntt_pallas

    gc.collect()
    torch.cuda.empty_cache()
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

    res = sparse_bootstrap_flow("cuda", log_n, timed)
    params, p_ci = res["params"], res["ci"]
    engines = {name: ring.ntt_engine for name, ring in
               (("Q", params.ring_q), ("P", params.ring_p), ("CI Q", p_ci.ring_q))}
    for name, eng in engines.items():
        want = "ci-plain" if name.startswith("CI") else "mxu64-plain"
        check(eng == want, f"phase 9b ring {name} on {eng}, not {want}")
    marks = {}

    def mark(name):
        torch.cuda.synchronize()
        marks[name] = time.perf_counter()

    ntt_mxu.reset_launches()
    ntt_pallas.reset_launches()
    mark("start")
    outs = res["sparse"](mark)
    mark("unpack")
    ci_outs = res["ci_pair"]()
    mark("ci")
    launches = {"ntt_mxu": dict(ntt_mxu.LAUNCHES), "ntt_pallas": dict(ntt_pallas.LAUNCHES)}
    for r in rows:
        r["sparse_btp_launches"] = launches["ntt_mxu" if r["name"].startswith("ntt_mxu")
                                            else "ntt_pallas"][
            "inverse" if r["name"].endswith("inverse") else "forward"]
    check(all(v == 0 for d in launches.values() for v in d.values()),
          f"a kernel launched on the mxu64-plain bootstraps: {launches}")
    bits = {"sparse": res["sparse_bits"](outs), "ci": res["ci_bits"](ci_outs)}
    for name, per_ct in bits.items():
        for worst, mean in per_ct:
            check(worst >= BTP9_MIN_BITS[0] and mean >= BTP9_MIN_BITS[1],
                  f"{name} bootstrap precision worst {worst:.2f} / mean {mean:.2f} "
                  f"bits below the floor {BTP9_MIN_BITS[0]} / {BTP9_MIN_BITS[1]}")
    ms = {"pack": marks["pack"] - marks["start"], "bootstrap": marks["boot"] - marks["pack"],
          "unpack": marks["unpack"] - marks["boot"], "CI pair": marks["ci"] - marks["unpack"]}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    phase_s = time.perf_counter() - t_phase
    print(f"phase 9b sparse and CI bootstraps: CKKS {BTP_PRESET} logN={params.log_n}, "
          f"CI twin logN={p_ci.log_n} ({p_ci.max_slots} real slots); engines {engines}; "
          "set-up ms: " + ", ".join(f"{k} {v:.1f}" for k, v in setup.items())
          + f" ({res['galois_keys']} Galois keys, the pack tree's included); "
          f"{len(outs)} ciphertexts of 2^{res['log_slots']} slots in one bootstrap and "
          f"2 CI ciphertexts in another: ms " + ", ".join(
              f"{k} {v * 1e3:.1f}" for k, v in ms.items())
          + "; worst / mean bits sparse " + ", ".join(
              f"{w:.2f} / {m:.2f}" for w, m in bits["sparse"]) + ", CI " + ", ".join(
              f"{w:.2f} / {m:.2f}" for w, m in bits["ci"])
          + f" (floor {BTP9_MIN_BITS[0]} / {BTP9_MIN_BITS[1]}); output levels "
          f"{sorted({o.level for o in outs + list(ci_outs)})} (output level "
          f"{res['btp'].output_level}); kernel launches {launches}; peak device memory "
          f"{peak_mb:.1f} MiB; the phase {phase_s:.1f} s")


def wire_poly_bytes(n: int, limbs: int) -> int:
    """Lattigo's bytes of one ring.Poly of ``limbs`` limbs at degree n: the
    row count, then each row's length and its n words (8 for no basis)."""
    return 8 + limbs * 8 * (n + 1)


def wire_gadget_bytes(n: int, lq: int, lp: int, cols: list[int]) -> int:
    """Bytes of a gadget ciphertext whose matrix rows have ``cols``
    columns, each a Vector of two ringqp.Polys of lq + lp limbs."""
    qp = wire_poly_bytes(n, lq) + wire_poly_bytes(n, lp)
    return 16 + sum(8 + c * (8 + 2 * qp) for c in cols)


def wire_tensors(obj) -> list:
    """Every tensor of one of the port's objects, in field order, with its
    scalar metadata (scale, flags, base2, Galois element)."""
    import dataclasses
    import torch
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj)
                for x in wire_tensors(getattr(obj, f.name))]
    if isinstance(obj, dict):
        return [x for k, v in sorted(obj.items()) for x in [k] + wire_tensors(v)]
    return [obj]


def wire_equal(a, b) -> bool:
    """Bit-equal tensors and equal metadata; a scale to 38 digits, as the
    metadata's 39-digit text keeps a rational scale like 2^56 / q."""
    from fractions import Fraction
    import torch

    def same(x, y):
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            return torch.equal(x, y)
        if isinstance(x, (int, Fraction)) and isinstance(y, (int, Fraction)) and x:
            return abs(Fraction(y) / Fraction(x) - 1) < Fraction(1, 10**38)
        return x == y

    ta, tb = wire_tensors(a), wire_tensors(b)
    return len(ta) == len(tb) and all(same(x, y) for x, y in zip(ta, tb))


def wire_flow(device, log_n: int = LOG_N):
    """Phase 10 on ``device`` (logN cut to ``log_n`` for a rehearsal on the
    CPU). Set-up: 10a's client (``bgv_tpu_params(log_n, LOG_QP)``, its
    keys) and the server, which rebuilds the parameters from the client's
    JSON and reads the relinearization key and the Galois key of
    rotate_columns(1) from bytes; 10b's two chains on the same 13 Q primes
    (no P; its first P prime), each with a base-2^WIRE_BASE2 relinearization
    key and an evaluation key sk -> sk2 sent over the wire; 10c's CKKS
    client at ``ckks_tpu_params(log_n, LOG_QP)`` whose evaluation-key set
    goes through ``serialization`` and back. Every object sent is read back,
    held bit-equal and its size held to Lattigo's layout; ``table`` collects
    (name, bytes, write ms, read ms) in order. ``run()`` is the main path:
    the 10a request (client encrypts and writes 4 + 4 ciphertexts, the server
    reads them, runs rotate_columns(rescale(mul_relin(a, b)), 1) and writes 4,
    the client reads and decodes), 10b's batch through rescale(mul_relin)
    and one apply_evaluation_key on each chain, and the 10c request
    (rotate(rescale(mul_relin(a, b)), 1) over the wire). It checks every
    BGV slot exactly and returns what the phase prints."""
    import numpy as np
    import torch
    from lattigo_tpu_torch import presets, rlwe
    from lattigo_tpu_torch.schemes import bgv, ckks
    from lattigo_tpu_torch.schemes.ckks import get_precision_stats
    from lattigo_tpu_torch.utils import lattigo_wire as wire, noise, serialization

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    table = []

    def send(name, obj, to_bytes, from_bytes, want_size):
        """obj over the wire: written, read back onto the device, held
        bit-equal and to Lattigo's size; returns what was read."""
        sync()
        t0 = time.perf_counter()
        data = to_bytes(obj)
        t1 = time.perf_counter()
        back = from_bytes(data)
        sync()
        t2 = time.perf_counter()
        check(len(data) == want_size, f"{name}: {len(data)} bytes, Lattigo's layout "
              f"gives {want_size}")
        check(wire_equal(back, obj), f"{name}: read(write(x)) != x")
        table.append((name, len(data), (t1 - t0) * 1e3, (t2 - t1) * 1e3))
        return back

    def split(ct):
        return [ct.replace(value=ct.value[i]) for i in range(ct.value.shape[0])]

    def stack(cts):
        return cts[0].replace(value=torch.stack([c.value for c in cts]))

    gen = torch.Generator(device=device).manual_seed(SEED * 10)

    # 10a set-up: the client's parameters and keys, the server's from bytes
    client = bgv.Parameters(presets.bgv_tpu_params(log_n, LOG_QP), device=device)
    n, lq, lp = client.n, len(client.q_moduli), len(client.p_moduli)
    kg = rlwe.KeyGenerator(client)
    sk = kg.gen_secret_key(gen)
    g1 = client.galois_element(1)
    rlk = kg.gen_relinearization_key(gen, sk)
    gk = kg.gen_galois_keys(gen, [g1], sk)[g1]
    text = client.literal.to_json()
    server = bgv.Parameters(bgv.ParametersLiteral.from_json(text), device=device)
    check(server == client and server.t == client.t, "the server's parameters != the client's")
    rns_cols = [1] * -(-lq // lp)
    rlk_s = send("rlk", rlk, wire.relinearization_key_to_bytes,
                 lambda b: wire.relinearization_key_from_bytes(b, device),
                 wire_gadget_bytes(n, lq, lp, rns_cols))
    gk_s = send("galois key", gk, lambda o: wire.galois_key_to_bytes(o, client.nth_root),
                lambda b: wire.galois_key_from_bytes(b, device),
                16 + wire_gadget_bytes(n, lq, lp, rns_cols))
    ev_s = bgv.Evaluator(server, rlwe.EvaluationKeySet(rlk_s, {g1: gk_s}))
    encoder, encryptor = bgv.Encoder(client), rlwe.Encryptor(client, sk)
    decryptor = rlwe.Decryptor(client, sk)
    x = wire_inputs(n, client.t, n // 2)
    a, b = x["a"], x["b"]
    ab = a * b % client.t
    half = n // 2
    want_bgv = np.concatenate([np.roll(ab[:, :half], -1, axis=-1),
                               np.roll(ab[:, half:], -1, axis=-1)], axis=-1)
    dims = (1, log_n - 1)

    def ct_bytes(level: int) -> int:
        return 1 + 277 + 8 + 2 * wire_poly_bytes(n, level + 1)

    def send_cts(name, ct):
        return stack([send(f"{name}[{i}]", c,
                           lambda o: wire.ciphertext_to_bytes(o, log_dimensions=dims),
                           lambda b: wire.ciphertext_from_bytes(b, device),
                           ct_bytes(c.level)) for i, c in enumerate(split(ct))])

    request_ms = {}

    def bgv_request():
        sync()
        t0 = time.perf_counter()
        ca = encryptor.encrypt(gen, encoder.encode(a), batch=(BATCH,))
        cb = encryptor.encrypt(gen, encoder.encode(b), batch=(BATCH,))
        ca_s, cb_s = send_cts("a", ca), send_cts("b", cb)
        sync()
        t1 = time.perf_counter()
        out = ev_s.rotate_columns(ev_s.rescale(ev_s.mul_relin(ca_s, cb_s)), 1)
        sync()
        t2 = time.perf_counter()
        got = encoder.decode(decryptor.decrypt(send_cts("result", out)))
        t3 = time.perf_counter()
        request_ms.update(end_to_end=(t3 - t0) * 1e3, server=(t2 - t1) * 1e3)
        check(np.array_equal(got, want_bgv), "10a: decoded slots != roll(a*b mod T)")
        return out

    # 10b set-up: the 13 Q primes with no P and with the first P prime
    b2 = {}
    for name, p in (("no P", None), ("one P", tuple(client.p_moduli[:1]))):
        params = bgv.Parameters(bgv.ParametersLiteral(
            log_n=log_n, q=tuple(client.q_moduli), p=p, t=client.t), device=device)
        check((params.basis_extender is None) == (p is None), f"10b {name}: basis extender")
        kgb = rlwe.KeyGenerator(params)
        s1, s2 = kgb.gen_secret_key(gen), kgb.gen_secret_key(gen)
        cols = wire._base2_digit_counts(params.q_moduli, WIRE_BASE2)
        size = wire_gadget_bytes(n, lq, len(params.p_moduli), cols)
        moduli = params.q_moduli
        rlk_b = send(f"base-2 rlk ({name})", kgb.gen_relinearization_key(gen, s1, base2=WIRE_BASE2),
                     lambda o: wire.relinearization_key_to_bytes(o, moduli),
                     lambda data: wire.relinearization_key_from_bytes(data, device), size)
        evk_b = send(f"base-2 evk ({name})", kgb.gen_evaluation_key(gen, s1, s2, base2=WIRE_BASE2),
                     lambda o: wire.evaluation_key_to_bytes(o, moduli),
                     lambda data: wire.evaluation_key_from_bytes(data, device), size)
        b2_rows = lq * max(cols)
        b2[name] = dict(params=params, s1=s1, s2=s2, evk=evk_b,
                        ev=bgv.Evaluator(params, rlwe.EvaluationKeySet(rlk_b)),
                        enc=bgv.Encoder(params), encr=rlwe.Encryptor(params, s1))

    def base2_run():
        out = {}
        for name, c in b2.items():
            params, enc, ev = c["params"], c["enc"], c["ev"]
            ca = c["encr"].encrypt(gen, enc.encode(a), batch=(BATCH,))
            cb = c["encr"].encrypt(gen, enc.encode(b), batch=(BATCH,))
            prod = ev.rescale(ev.mul_relin(ca, cb))
            got = enc.decode(rlwe.Decryptor(params, c["s1"]).decrypt(prod))
            check(np.array_equal(got, ab), f"10b {name}: slots != a*b mod T")
            sw = ev.apply_evaluation_key(split(ca)[0], c["evk"])
            got = enc.decode(rlwe.Decryptor(params, c["s2"]).decrypt(sw))
            check(np.array_equal(got, a[0]), f"10b {name}: key switch != a")
            out[name] = (ca, prod, sw)
        return out

    def base2_noise(outs):
        """log2 std of the noise: fresh, after mul_relin + rescale, after
        apply_evaluation_key (each against its exact plaintext)."""
        res = {}
        for name, (ca, prod, sw) in outs.items():
            c = b2[name]
            params, enc, rq = c["params"], c["enc"], c["params"].ring_q
            fresh_pt = rq.intt(enc.encode(a[0]).value)
            p0 = split(prod)[0]
            prod_pt = rq.intt(enc.encode(ab[0], p0.level, p0.scale).value, p0.level)
            res[name] = (noise.log2_noise_std(params, c["s1"], split(ca)[0], fresh_pt),
                         noise.log2_noise_std(params, c["s1"], p0, prod_pt),
                         noise.log2_noise_std(params, c["s2"], sw, fresh_pt),
                         params.noise_fresh_sk())
        return res

    # 10c set-up: the CKKS client; its evaluation-key set through serialization
    cp = ckks.Parameters(presets.ckks_tpu_params(log_n, LOG_QP), device=device)
    kgc = rlwe.KeyGenerator(cp)
    skc = kgc.gen_secret_key(gen)
    g1c = cp.galois_element(1)
    keys = rlwe.EvaluationKeySet(kgc.gen_relinearization_key(gen, skc),
                                 kgc.gen_galois_keys(gen, [g1c], skc))
    sync()
    t0 = time.perf_counter()
    blob = serialization.dumps(keys)
    t1 = time.perf_counter()
    keys_s = serialization.loads(blob, device=device)
    sync()
    t2 = time.perf_counter()
    check(wire_equal(keys_s, keys), "10c: serialization.loads(dumps(keys)) != keys")
    ser_stats = (len(blob), (t1 - t0) * 1e3, (t2 - t1) * 1e3)
    ev_c = ckks.Evaluator(cp, keys_s)
    enc_c, encr_c, dec_c = ckks.Encoder(cp), rlwe.Encryptor(cp, skc), rlwe.Decryptor(cp, skc)
    check(cp.max_slots == x["za"].shape[-1], "10c: slot count != the inputs'")
    za, zb = x["za"], x["zb"]
    want_c = np.roll(za * zb, -1, axis=-1)
    cdims = (0, cp.log_max_slots)

    def send_ckks(name, ct):
        return stack([send(f"ckks {name}[{i}]", c,
                           lambda o: wire.ciphertext_to_bytes(o, log_dimensions=cdims),
                           lambda data: wire.ciphertext_from_bytes(data, device),
                           ct_bytes(c.level)) for i, c in enumerate(split(ct))])

    def ckks_request():
        """The server's result decoded before and after its trip back."""
        ca = encr_c.encrypt(gen, enc_c.encode(za), batch=(BATCH,))
        cb = encr_c.encrypt(gen, enc_c.encode(zb), batch=(BATCH,))
        out = ev_c.rotate(ev_c.rescale(ev_c.mul_relin(send_ckks("a", ca), send_ckks("b", cb))), 1)
        back = send_ckks("result", out)
        check(back.level == out.level == cp.max_level - 1 and back.is_ntt
              and wire_equal(back.scale, out.scale), "10c: level, domain or scale changed")
        before = enc_c.decode(dec_c.decrypt(out))
        after = enc_c.decode(dec_c.decrypt(back))
        check(np.array_equal(before, after), "10c: decoded slots changed on the wire")
        st = get_precision_stats(want_c, after)
        return st.min_precision, st.avg_precision, out.scale

    def run():
        out = bgv_request()
        outs = base2_run()
        ckks_bits = ckks_request()
        return dict(bgv=out, base2=outs, ckks_bits=ckks_bits)

    return dict(client=client, b2={k: c["params"] for k, c in b2.items()}, ckks=cp,
                b2_rows=b2_rows, b2_digits=cols,
                run=run, bgv_request=bgv_request, base2_run=base2_run,
                base2_noise=base2_noise, table=table, request_ms=request_ms,
                ser_stats=ser_stats, json=text)


def phase_wire(rows, log_n: int = LOG_N):
    import torch
    from lattigo_tpu_torch.ring import ntt_mxu, ntt_pallas

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    res = wire_flow("cuda", log_n)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    engines = {"Q": res["client"].ring_q, "P": res["client"].ring_p,
               "T": res["client"].ring_t, "CKKS Q": res["ckks"].ring_q,
               "CKKS P": res["ckks"].ring_p}
    for name, p in res["b2"].items():
        engines[f"{name} Q"] = p.ring_q
        if p.ring_p is not None:
            engines[f"{name} P"] = p.ring_p
    engines = {k: r.ntt_engine for k, r in engines.items()}
    for k, eng in engines.items():
        check(eng == "mxu-cuda", f"phase 10 ring {k} on {eng}, not mxu-cuda")

    # the main path once, the four-step calls recorded
    ntt_pallas.reset_launches()
    outs, calls, launches = record_calls(ntt_mxu, "four_step_cuda", res["run"])
    check(all(v == 0 for v in ntt_pallas.LAUNCHES.values()),
          f"the u32 kernel launched in phase 10: {ntt_pallas.LAUNCHES}")
    mxu_rows = [r for r in rows if r["name"].startswith("ntt_mxu")]
    for r in rows:
        counts = launches if r["name"].startswith("ntt_mxu") else ntt_pallas.LAUNCHES
        r["phase10_launches"] = counts["inverse" if r["name"].endswith("inverse") else "forward"]
    for r in mxu_rows:
        check(r["phase10_launches"] > 0, f"{r['name']} not launched in phase 10")
    launch = ntt_mxu.four_step_cuda
    for eng, xin, limb_lo, inverse, lazy in calls.values():
        k = launch(eng, xin, limb_lo, inverse, lazy)
        want_k = ntt_mxu.four_step_plain(eng, xin, limb_lo, inverse, lazy)
        for r in mxu_rows:
            if r["name"].endswith("inverse") == inverse:
                r["max_abs_err"] = max(r["max_abs_err"], int((k - want_k).abs().max()))
        check(torch.equal(k, want_k), f"kernel != plain at phase-10 call "
              f"{tuple(xin.shape)} limb_lo={limb_lo} inverse={inverse}")
    digit_calls = sorted({tuple(x.shape) for _, x, _, inv, _ in calls.values()
                          if not inv and x.dim() == 4 and x.shape[-3] == res["b2_rows"]})
    noise_bits = res["base2_noise"](outs["base2"])
    ckks_min, ckks_avg, ckks_scale = outs["ckks_bits"]
    table = res["table"]

    # the BGV request again for its ms (the main path's run was the first)
    res["bgv_request"]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res["base2_run"]()
    torch.cuda.synchronize()
    base2_ms = (time.perf_counter() - t0) * 1e3
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    phase_s = time.perf_counter() - t_phase

    def rate(nbytes, ms):
        return nbytes / 1e6 / (ms / 1e3) if ms > 0 else float("inf")

    by_kind = {}
    for name, nbytes, w_ms, r_ms in table:
        kind = name.split("[")[0]
        k = by_kind.setdefault(kind, [nbytes, 0.0, 0.0, 0])
        k[1] += w_ms
        k[2] += r_ms
        k[3] += 1
    client = res["client"]
    print(f"phase 10a wire: BGV logN={client.log_n} Q={len(client.q_moduli)}x28-bit "
          f"P={len(client.p_moduli)}x28-bit T={client.t}; the server rebuilt equal "
          f"parameters from the client's {len(res['json'])}-byte JSON; {BATCH} requests "
          f"rotate_columns(rescale(mul_relin(a, b)), 1) over Lattigo's bytes decode to "
          f"roll(a*b mod T) in every slot; {len(table)} objects sent, each read back "
          f"bit-equal at Lattigo's size; request end to end "
          f"{res['request_ms']['end_to_end']:.1f} ms (the server's evaluation "
          f"{res['request_ms']['server']:.1f} ms); engines {engines}")
    print("phase 10 objects (bytes each, write / read ms mean, write / read MB/s; "
          "x count): " + "; ".join(
              f"{kind} {nb} B, {w / c:.2f} / {r / c:.2f} ms, {rate(nb, w / c):.0f} / "
              f"{rate(nb, r / c):.0f} MB/s x{c}" for kind, (nb, w, r, c) in by_kind.items()))
    print(f"phase 10b base-2 w={WIRE_BASE2}: " + "; ".join(
        f"{name} ({len(p.q_moduli)} Q + {len(p.p_moduli)} P primes): batch of {BATCH} "
        f"rescale(mul_relin) and apply_evaluation_key exact; log2 noise std fresh "
        f"{f:.2f}, after mul_relin+rescale {m:.2f}, after the key switch {s:.2f} "
        f"(noise_fresh_sk {sig} = 2^{math.log2(sig):.2f})"
        for (name, p), (f, m, s, sig) in zip(res["b2"].items(), noise_bits.values()))
        + f"; both chains {base2_ms:.1f} ms; digit NTT calls {digit_calls}")
    n_ser, w_ser, r_ser = res["ser_stats"]
    print(f"phase 10c: CKKS logN={res['ckks'].log_n} request rotate(rescale(mul_relin)) "
          f"over the wire at {ckks_min:.2f} / {ckks_avg:.2f} bits min / avg, equal before "
          f"and after, scale {float(ckks_scale):.6e} kept; serialization of the key set "
          f"{n_ser} B, dumps {w_ser:.1f} ms, loads onto the card {r_ser:.1f} ms, "
          f"bit-equal; four-step bit-equal to plain at the {len(calls)} distinct calls; "
          f"launches on the main path {launches}; set-up {setup_s:.1f} s; peak device "
          f"memory {peak_mb:.1f} MiB; the phase {phase_s:.1f} s")


def dm_chains():
    """Phase 11a's chains: (name, logN, moduli, polynomials): the bootstrap
    preset's Q and P primes, the flagship's 3 x 40-bit Q primes
    (``__graft_entry__.py``) and 4 61-bit primes below 2^61 at logN 16."""
    from lattigo_tpu_torch.circuits import bootstrapping_presets as bp
    from lattigo_tpu_torch.rlwe.params import gen_moduli
    from lattigo_tpu_torch.utils.primes import NTTFriendlyPrimesGenerator

    lit, _ = bp.build_bootstrapping_parameters(*getattr(bp, BTP_PRESET))
    q, p = gen_moduli(lit.log_n, 2 << lit.log_n, lit.log_q, lit.log_p)
    flag_q, _ = gen_moduli(12, 2 << 12, (40,) * 3, ())
    gen61 = NTTFriendlyPrimesGenerator(61, 2 << 16)
    return [("bootstrap", lit.log_n, q + p, BATCH),
            ("flagship", 12, flag_q, 2),
            ("61-bit", 16, [gen61.next_downstream_prime() for _ in range(4)], 2)]


def mxu64_bound(eng, shape) -> tuple[float, str]:
    """Least time for one u64 four-step call on x int64[shape]: each input
    and output byte moved once (data + the used limbs' tables) against the
    int8 multiply-adds of its two contractions, at the published peaks."""
    polys = math.prod(shape[:-1])
    limbs = shape[-2]
    r, c, n = eng.rr, eng.cc, eng.n
    ni, no = eng.nd_in, eng.nd_out
    table_bytes = limbs * (2 * ni * no * (r * r + c * c) + 2 * 8 * n + 5 * 8)
    nbytes = 2 * 8 * polys * n + table_bytes
    ops = 2 * polys * ni * no * r * c * (r + c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_digit_matmul(rows):
    import copy
    import torch
    from lattigo_tpu_torch.presets import bgv_tpu_params
    from lattigo_tpu_torch.ring import basis_extension, ntt as ntt_mod, ntt_u64_mxu
    from lattigo_tpu_torch.ring.ring import Ring, SubRing
    from lattigo_tpu_torch.ring.sampling import KeyedPRNG
    from lattigo_tpu_torch.schemes import bgv

    gc.collect()
    torch.cuda.empty_cache()
    held_mb = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    # 11a: the u64 four-step engine against radix-2 on three chains
    for name, log_n, moduli, polys in dm_chains():
        n, L = 1 << log_n, len(moduli)
        psis = [SubRing(n, q).psi for q in moduli]
        ntt_u64_mxu._prime_tables.cache_clear()
        t0 = time.perf_counter()
        ntt_u64_mxu.NTTMxu64(n, moduli, psis, "cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ring = Ring(n, moduli, device="cuda")           # its tables from the cache
        check(ring.ntt_engine == "mxu64-plain", f"11a {name} ring on {ring.ntt_engine}")
        eng = ring._kernel
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        q = ring.q
        # the top of the engine's input contract: uniform in [0, 2q), the
        # first 8 coefficients of every limb 2q - 1
        x = torch.stack([torch.randint(0, 2 * qi, (polys, n), generator=gen,
                                       device="cuda", dtype=torch.int64)
                         for qi in moduli], dim=-2)
        x[..., :8] = 2 * q - 1

        def radix2(v, inverse, lazy, s=slice(0, L)):
            if inverse:
                return ntt_mod.intt(v, ring.iroots[s], ring.ninv[s], q[s], ring.qinv[s],
                                    log_n, lazy=lazy, small=ring.small)
            return ntt_mod.ntt(v, ring.roots[s], q[s], ring.qinv[s], log_n,
                               lazy=lazy, small=ring.small)

        for inverse in (False, True):
            fn = ring.intt if inverse else ring.ntt
            got, want = fn(x), radix2(x, inverse, False)
            check(torch.equal(got, want), f"11a {name}: mxu64 != radix-2, inverse={inverse}")
            got_l, want_l = fn(x, lazy=True), radix2(x, inverse, True)
            check(torch.equal(got_l % q, want_l % q) and bool((got_l < 2 * q).all()),
                  f"11a {name}: lazy mxu64 != radix-2 mod q, inverse={inverse}")
            for route in ("int8", "f64"):
                check(torch.equal(eng._apply(x, slice(0, L), inverse, False, route), got),
                      f"11a {name}: route {route} differs, inverse={inverse}")
            one = x[..., 1:2, :].contiguous()
            single = (ring.intt_single if inverse else ring.ntt_single)(1, one)
            check(torch.equal(single, radix2(one, inverse, False, slice(1, 2))),
                  f"11a {name}: single limb 1 != radix-2, inverse={inverse}")
        check(torch.equal(ring.intt(ring.ntt(x)), x % q), f"11a {name}: INTT(NTT(x)) != x")

        reps = 5 if n * L * polys > 1 << 21 else 20
        ms = {}
        for inverse in (False, True):
            d = "inv" if inverse else "fwd"
            ms[f"mxu64 {d}"] = [cuda_ms(lambda: eng._apply(x, slice(0, L), inverse, False),
                                        reps)]
            ms[f"radix-2 {d}"] = [cuda_ms(lambda: radix2(x, inverse, False), reps)]
            # the two contractions in turns: int8, f64, f64, int8
            for route in ("int8", "f64", "f64", "int8"):
                ms.setdefault(f"{route} {d}", []).append(cuda_ms(
                    lambda: eng._apply(x, slice(0, L), inverse, False, route), reps))
        ops = {}
        for label, fn in (("mxu64", lambda: ring.ntt(x)),
                          ("radix-2", lambda: radix2(x, False, False)),
                          ("f64 route", lambda: eng._apply(x, slice(0, L), False, False, "f64"))):
            with OpCounter() as counter:
                fn()
            ops[label] = counter.total
        work = {}
        for label, fn in (("mxu64", lambda: ring.ntt(x)), ("radix-2", lambda: radix2(x, False, False))):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            work[label] = (torch.cuda.max_memory_allocated() - base) / 2**20
        bound, by = mxu64_bound(eng, tuple(x.shape))
        print(f"phase 11a u64 four-step engine, {name}: {tuple(x.shape)} on "
              f"{[qi.bit_length() for qi in moduli]}-bit primes, R x C = {eng.rr} x "
              f"{eng.cc}, digit planes {eng.nd_in} x {eng.nd_out}; equal to radix-2 "
              f"forward and inverse (lazy mod q and below 2q), at limb 1, both "
              f"contractions; INTT(NTT(x)) = x; CUDA-event ms (mean of {reps}; the "
              f"contractions timed in turns, a / b): "
              + ", ".join(f"{k} " + " / ".join(f"{t:.4f}" for t in v) for k, v in ms.items())
              + f"; bound {bound:.4f} ms ({by}); dispatched torch ops per forward "
              f"call {ops}; tables {eng.table_bytes() / 2**20:.1f} MiB, built cold "
              f"on the host in {build_s:.2f} s; working memory of one forward call "
              + ", ".join(f"{k} {v:.1f} MiB" for k, v in work.items()))
        del ring, eng, x
        gc.collect()
        torch.cuda.empty_cache()

    # 11b: the ModUp digit-matmul contraction against the raw MAC
    torch.cuda.reset_peak_memory_stats()
    params = bgv.Parameters(bgv_tpu_params(LOG_N, LOG_QP), device="cuda")
    rq, rp, rt = params.ring_q, params.ring_p, params.ring_t
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    convs = [("Q -> T decode", params.q_moduli[:12], [params.t], rt),
             ("Q -> P full level", params.q_moduli, params.p_moduli, rp)]
    texts = []
    for label, src, dst, rd in convs:
        consts = basis_extension.ModUpConstants(src, dst, "cuda")
        check(consts.mxu, f"11b {label}: not on the digit-matmul route")
        raw = copy.copy(consts)
        raw.mxu = False
        x = torch.stack([torch.randint(0, qi, (BATCH, params.n), generator=gen,
                                       device="cuda", dtype=torch.int64)
                         for qi in src], dim=-2)
        dq = rd.q[:len(dst)]
        args = (dq, rd.qinv[:len(dst)], rd.bred_hi[:len(dst)])
        got = basis_extension.mod_up(x, consts, *args)
        want = basis_extension.mod_up(x, raw, *args)
        check(torch.equal(got, want), f"11b {label}: digit matmul != raw MAC")
        t_mxu = cuda_ms(lambda: basis_extension.mod_up(x, consts, *args), 20)
        t_raw = cuda_ms(lambda: basis_extension.mod_up(x, raw, *args), 20)
        texts.append(f"{label} {tuple(x.shape)} -> {tuple(got.shape)}: digit matmul "
                     f"{t_mxu:.4f} ms, raw MAC {t_raw:.4f} ms")
    print(f"phase 11b ModUp contraction on bgv_tpu_params({LOG_N}, {LOG_QP}), equal to "
          "the raw multiply-accumulate; CUDA-event ms of mod_up (mean of 20): "
          + "; ".join(texts) + f"; digit-matmul contractions on the main paths "
          f"{MODUP_MXU_CALLS}")

    # 11c: the native XOF against the hashlib loop, phase 6's public-key CRP
    def crp(plain: bool):
        prng = KeyedPRNG(b"mp-cpk")
        if plain:
            prng.read_u64 = prng.read_u64_plain
        t0 = time.perf_counter()
        out = torch.cat([prng.uniform_poly(rq), prng.uniform_poly(rp)], dim=-2)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    crp(False)
    native, native_ms = crp(False)
    plain, plain_ms = crp(True)
    check(torch.equal(native, plain), "11c native XOF != hashlib loop")
    check(bool((native < torch.cat([rq.q, rp.q])).all()), "11c CRP residues not reduced")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    print(f"phase 11c XOF: the {tuple(native.shape)} CRP of seed b'mp-cpk' equal from "
          f"the native XOF and the hashlib loop; host ms native {native_ms:.1f}, "
          f"hashlib {plain_ms:.1f}; peak device memory of 11b-c {peak_mb:.1f} MiB "
          f"({held_mb:.1f} held by earlier phases at the start); the phase "
          f"{time.perf_counter() - t_phase:.1f} s")


# -- phase 12: scale-out; phase 13: the examples -----------------------------------

# phase 12: ranks share the one card over gloo; 12a's chain is phase 11a's
# 61-bit one (4 primes below 2^61 at logN 16, 2 polynomials); 12b / 12c
# run one level below the top (12 Q limbs, which limb 2 divides)
SCALE_OUT_WORLD, SCALE_OUT_BACKEND = 4, "gloo"
SP_LOG_N, SP_POLYS = 16, 2
SCALE_OUT_REPS = 10
HOISTED_ROTS = [1, 3]
# phase 13: the JAX package's test arguments (tests/test_examples.py)
EXAMPLES = {
    "ckks_tutorial": {}, "ckks_sigmoid": {}, "ckks_sigmoid_minimax": {},
    "bgv_vectorized_ole": {}, "bgv_ride_hailing": dict(n_drivers=8),
    "ckks_scheme_switching": {}, "rgsw_blind_rotations": {}, "multiparty_psi": {},
    "thresh_eval_key_gen": dict(n_parties=3, t=2), "int_pir": dict(n_parties=2),
    "ckks_bootstrapping": {}, "ckks_vectorized_polynomial_evaluation": {},
    "template_ckks": {}, "template_bgv": {}, "ckks_bootstrapping_slim": {},
    "ckks_bootstrapping_high_precision": {},
}


def scale_out_inputs():
    """12b's and 12c's set-ups in this process: phase 3's BGV server
    (bgv_tpu_params(14, 438), keys from SEED) with a batch of 4 a and b one
    level below the top, and a CKKS ckks_tpu_params(14, 438) ciphertext of
    4 vectors at that level with the Galois keys of HOISTED_ROTS; each with
    its one-process step."""
    import numpy as np
    import torch
    from lattigo_tpu_torch import rlwe
    from lattigo_tpu_torch.presets import bgv_tpu_params, ckks_tpu_params
    from lattigo_tpu_torch.schemes import bgv, ckks

    params = bgv.Parameters(bgv_tpu_params(LOG_N, LOG_QP), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kg = rlwe.KeyGenerator(params)
    sk = kg.gen_secret_key(gen)
    ev = bgv.Evaluator(params, rlwe.EvaluationKeySet(kg.gen_relinearization_key(gen, sk)))
    encoder, encryptor = bgv.Encoder(params), rlwe.Encryptor(params, sk)
    rng = np.random.default_rng(SEED)
    a = rng.integers(0, params.t, (BATCH, params.n))
    b = rng.integers(0, params.t, (BATCH, params.n))
    level = params.max_level - 1
    ca = encryptor.encrypt(gen, encoder.encode(a), batch=(BATCH,)).at_level(level)
    cb = encryptor.encrypt(gen, encoder.encode(b), batch=(BATCH,)).at_level(level)
    bgv_in = dict(params=params, ev=ev, a=a, b=b, ca=ca, cb=cb, encoder=encoder,
                  decryptor=rlwe.Decryptor(params, sk))

    cp = ckks.Parameters(ckks_tpu_params(LOG_N, LOG_QP), device="cuda")
    kc = rlwe.KeyGenerator(cp)
    skc = kc.gen_secret_key(gen)
    els = [cp.galois_element(r) for r in HOISTED_ROTS]
    cev = ckks.Evaluator(cp, rlwe.EvaluationKeySet(galois_keys=kc.gen_galois_keys(
        gen, els, skc, levels={g: level for g in els})))
    v = rng.uniform(-1, 1, (BATCH, cp.max_slots)) + 1j * rng.uniform(-1, 1, (BATCH, cp.max_slots))
    cct = rlwe.Encryptor(cp, skc).encrypt(gen, ckks.Encoder(cp).encode(v, level=level),
                                          batch=(BATCH,))
    return bgv_in, dict(params=cp, ev=cev, ct=cct, level=level)


def phase_scale_out(rows):
    import numpy as np
    import torch
    from lattigo_tpu_torch import interop
    from lattigo_tpu_torch.parallel import dryrun, launch
    from lattigo_tpu_torch.rlwe.elements import Ciphertext
    from lattigo_tpu_torch.utils.primes import NTTFriendlyPrimesGenerator

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    world, backend = SCALE_OUT_WORLD, SCALE_OUT_BACKEND
    # 12a inputs: phase 11a's 61-bit chain at logN 16
    n = 1 << SP_LOG_N
    gen61 = NTTFriendlyPrimesGenerator(61, 2 * n)
    moduli = [gen61.next_downstream_prime() for _ in range(4)]
    rng = np.random.default_rng(SEED)
    qcol = np.array(moduli, dtype=np.uint64)[None, :, None]
    sa, sb = (rng.integers(0, 1 << 62, (SP_POLYS, 4, n)).astype(np.uint64) % qcol
              for _ in range(2))
    # 12b and 12c: the one-process steps, on this process's card
    bgv_in, ck = scale_out_inputs()
    ev, ca, cb = bgv_in["ev"], bgv_in["ca"], bgv_in["cb"]
    ref = ev.rescale(ev.mul_relin(ca, cb))
    one_ms = cuda_ms(lambda: ev.rescale(ev.mul_relin(ca, cb)), SCALE_OUT_REPS)
    got = bgv_in["encoder"].decode(bgv_in["decryptor"].decrypt(ref))
    check(np.array_equal(got, bgv_in["a"] * bgv_in["b"] % bgv_in["params"].t),
          "phase 12b: the one-process step does not decode to a*b mod T")
    cev, cct = ck["ev"], ck["ct"]
    href = cev.rotate_columns_hoisted(cct, HOISTED_ROTS)
    h_one_ms = cuda_ms(lambda: cev.rotate_columns_hoisted(cct, HOISTED_ROTS),
                       SCALE_OUT_REPS)
    rlk = ev.evk.relinearization_key.gadget.value
    programs = [
        ("sp", dict(n=n, moduli=moduli, a=sa, b=sb, reps=SCALE_OUT_REPS)),
        ("bgv_step", dict(dp=2, limb=2, literal_json=bgv_in["params"].literal.to_json(),
                          rlk_rows=(interop.to_numpy(rlk.q), interop.to_numpy(rlk.p)),
                          a=interop.to_numpy(ca.value), b=interop.to_numpy(cb.value),
                          scale=ca.scale, reps=SCALE_OUT_REPS, record=True)),
        ("hoisted", dict(limb=2, literal_json=ck["params"].literal.to_json(),
                         galois_rows={g: (interop.to_numpy(k.gadget.value.q),
                                          interop.to_numpy(k.gadget.value.p))
                                      for g, k in cev.evk.galois_keys.items()},
                         ct=interop.to_numpy(cct.value), rots=HOISTED_ROTS,
                         reps=SCALE_OUT_REPS, record=True)),
    ]
    t0 = time.perf_counter()
    ranks = launch.run(dryrun.programs_rank, world, "cuda", programs, backend=backend)
    world_s = time.perf_counter() - t0
    sp, step, hz = ([r[i] for r in ranks] for i in range(3))

    # 12a: the sp-sharded NTT at full width
    for r in sp:
        check(all(r["checks"].values()), f"phase 12a: sharded != one process {r['checks']}")
    sp_ms = {k: max(r["ms"][k] for r in sp) for k in sp[0]["ms"]}
    print(f"phase 12 scale-out: {world} ranks, processes that share cuda:0 over "
          f"{backend} (world {world_s:.1f} s, spawn and set-up included)")
    print(f"phase 12a sp-sharded NTT: logN={SP_LOG_N}, {len(moduli)} primes below "
          f"2^61, {SP_POLYS} polynomials, D={world} (a rank {sp[0]['local_shape']}): "
          f"forward, inverse (lazy and not) and negacyclic_mul_sharded bit-equal "
          f"to the one-process {sp[0]['engine']} ring (lazy mod q) on every rank; "
          f"ms (CUDA events, max over ranks) sharded NTT {sp_ms['ntt']:.3f}, "
          f"INTT {sp_ms['intt']:.3f}, one-process NTT {sp_ms['ntt_one']:.3f}, "
          f"INTT {sp_ms['intt_one']:.3f} (4 ranks on one card); bytes a rank over "
          f"the five transforms and the gathers: swapped {sp[0]['stats']['swapped']}, "
          f"gathered {sp[0]['stats']['gathered']}, staged through the host "
          f"{sp[0]['stats']['staged']}")

    # 12b: the dp x limb BGV step
    check(np.array_equal(step[0]["output"], interop.to_numpy(ref.value)),
          "phase 12b: the gathered step != phase 3's evaluator in one process")
    out = Ciphertext(value=interop.to_torch(step[0]["output"], "cuda"), is_ntt=True,
                     scale=step[0]["scale"])
    dec = bgv_in["encoder"].decode(bgv_in["decryptor"].decrypt(out))
    check(np.array_equal(dec, bgv_in["a"] * bgv_in["b"] % bgv_in["params"].t),
          "phase 12b: the gathered step does not decode to a*b mod T")
    digest = dryrun.keys_digest(ev.evk)
    check(all(r["keys_digest"] == digest for r in step),
          "phase 12b: a rank's keys differ from this process's")
    check(all(r["keys_digest"] == dryrun.keys_digest(cev.evk) for r in hz),
          "phase 12c: a rank's keys differ from this process's")
    for name, part in (("12b", step), ("12c", hz)):
        for i, r in enumerate(part):
            check(r["launches"]["forward"] > 0 and r["launches"]["inverse"] > 0,
                  f"phase {name}: rank {i} launched no four-step kernel: {r['launches']}")
            check(r["held"]["calls"] > 0 and r["held"]["max_abs_err"] == 0,
                  f"phase {name}: rank {i} kernel calls not held: {r['held']}")
            check(r["engines"] == ["mxu-cuda"], f"phase {name}: shard rings {r['engines']}")
    for r in rows:
        if r["name"].startswith("ntt_mxu"):
            d = "inverse" if r["name"].endswith("inverse") else "forward"
            r["scale_out_launches"] = sum(x["launches"][d] for x in step + hz)
        else:
            r["scale_out_launches"] = 0
    print(f"phase 12b dp x limb BGV step: bgv_tpu_params({LOG_N}, {LOG_QP}), "
          f"mesh dp 2 x limb 2, batch {BATCH} at {ca.level + 1} Q limbs (a rank "
          f"{step[0]['local_in']} in, {[r['local_out'] for r in step]} out), "
          f"gathered {step[0]['out_shape']} bit-equal to phase 3's evaluator in one "
          f"process and a*b mod T in every slot; keys equal on every rank; shard "
          f"rings {step[0]['engines']}; four-step launches per rank "
          f"{[r['launches'] for r in step]}, every distinct call held against the "
          f"plain version ({[r['held']['calls'] for r in step]} calls: "
          f"{step[0]['held']['shapes']}); step ms (CUDA events, max over ranks, "
          f"after a warm-up) {max(r['ms'] for r in step):.3f}, with the output "
          f"gather {max(r['ms_gathered'] for r in step):.3f}, one process "
          f"{one_ms:.3f}; bytes a rank receives per step (gathered + broadcast) "
          f"{[r['step_bytes']['gathered'] + r['step_bytes']['broadcast'] for r in step]}"
          f", staged through the host {[r['step_bytes']['staged'] for r in step]}, "
          f"output gather {[r['output_bytes'] for r in step]}; peak MiB per rank "
          f"{[round(r['peak_mib'], 1) for r in step]}")

    # 12c: limb-sharded hoisted rotations
    for k in HOISTED_ROTS:
        check(np.array_equal(hz[0]["outputs"][k], interop.to_numpy(href[k].value)),
              f"phase 12c: rotation {k} != one process")
    print(f"phase 12c limb-sharded hoisted rotations {HOISTED_ROTS}: "
          f"ckks_tpu_params({LOG_N}, {LOG_QP}), limb 2 (dp ranks replicate), "
          f"{BATCH} ciphertexts at {ck['level'] + 1} Q limbs (a rank "
          f"{hz[0]['local_in']}), bit-equal to one process; four-step launches per "
          f"rank {[r['launches'] for r in hz]}, {[r['held']['calls'] for r in hz]} "
          f"distinct calls held; ms (max over ranks) {max(r['ms'] for r in hz):.3f}, "
          f"one process {h_one_ms:.3f}; bytes a rank receives "
          f"{[r['step_bytes']['gathered'] for r in hz]}, staged "
          f"{[r['step_bytes']['staged'] for r in hz]}; peak MiB per rank "
          f"{[round(r['peak_mib'], 1) for r in hz]}")
    del bgv_in, ck, ref, href, ev, cev, ca, cb, cct, out
    gc.collect()
    torch.cuda.empty_cache()

    # 12d: the dry run at the JAX dry run's shapes
    t0 = time.perf_counter()
    r0 = dryrun.dryrun_multichip(world, device="cuda", backend=backend)
    print(f"phase 12d dryrun_multichip({world}, device='cuda', backend='{backend}'): "
          f"passed in {time.perf_counter() - t0:.1f} s; bootstrap bits "
          f"{[round(x, 2) for x in r0['bootstrap_bits']]}, packed pair "
          f"{[round(x, 2) for x in r0['packed_bits']]}; mesh checks "
          f"{r0['mesh_checks']}; the phase {time.perf_counter() - t_phase:.1f} s")


def phase_examples(rows):
    import importlib
    import torch
    from lattigo_tpu_torch.ring import ntt_mxu, ntt_pallas
    from lattigo_tpu_torch.ring import ring as ring_mod

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    init = ring_mod.Ring.__init__
    engines: set = set()

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        engines.add(self.ntt_engine)

    totals = {"ntt_mxu": {"forward": 0, "inverse": 0},
              "ntt_pallas": {"forward": 0, "inverse": 0}}
    held, err, lines = 0, 0, []
    ring_mod.Ring.__init__ = recording_init
    try:
        for name, kwargs in EXAMPLES.items():
            engines.clear()
            mod = importlib.import_module(f"lattigo_tpu_torch.examples.{name}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (_, calls, u32), mxu_calls, mxu = record_calls(
                ntt_mxu, "four_step_cuda", lambda: record_calls(
                    ntt_pallas, "u32_cuda", lambda: mod.main(device="cuda", **kwargs)))
            ms = (time.perf_counter() - t0) * 1e3
            for k in ("forward", "inverse"):
                totals["ntt_pallas"][k] += u32[k]
                totals["ntt_mxu"][k] += mxu[k]
            for module, fam, recorded in ((ntt_pallas, "u32", calls),
                                          (ntt_mxu, "four_step", mxu_calls)):
                for eng, x, lo, inverse, lazy in recorded.values():
                    got = getattr(module, f"{fam}_cuda")(eng, x, lo, inverse, lazy)
                    want = getattr(module, f"{fam}_plain")(eng, x, lo, inverse, lazy)
                    err = max(err, int((got - want).abs().max()))
                    check(torch.equal(got, want), f"phase 13 {name}: {fam} kernel != "
                          f"plain at {tuple(x.shape)} inverse={inverse}")
                held += len(recorded)
            lines.append(f"{name} {ms:.1f} ms {sorted(engines)} four-step {mxu} "
                         f"u32 {u32}")
    finally:
        ring_mod.Ring.__init__ = init
    for r in rows:
        fam = "ntt_mxu" if r["name"].startswith("ntt_mxu") else "ntt_pallas"
        r["examples_launches"] = totals[fam]["inverse" if r["name"].endswith("inverse")
                                             else "forward"]
    check(totals["ntt_pallas"]["forward"] > 0 and totals["ntt_pallas"]["inverse"] > 0,
          "phase 13: the blind-rotation example launched no u32 kernel")
    print(f"phase 13 examples: all {len(EXAMPLES)} main()s passed their asserts on "
          f"the card (the JAX test's arguments); {held} distinct kernel calls held "
          f"against the plain version (max |err| {err}); " + "; ".join(lines)
          + f"; the phase {time.perf_counter() - t_phase:.1f} s")


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
    phase_circuits(rows)
    phase_ring_packing(rows)
    phase_sparse_bootstrap(rows)
    phase_wire(rows)
    phase_digit_matmul(rows)
    phase_scale_out(rows)
    phase_examples(rows)
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
