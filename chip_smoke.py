#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero before the result):

1. build every CUDA kernel of the path from ``lattigo_tpu_torch/csrc``
   (one ``nvcc`` per source, started together);
2. hold each kernel bit for bit against its plain torch version on the card
   at the slice's shapes (4 polynomials x 15 limbs x 16384), lazy and not,
   through a non-zero limb offset too, and NTT then INTT as the identity;
   time kernel and plain version with CUDA events;
3. serve one batch of 4 requests on BGV ``bgv_tpu_params(14, 438)``
   (N = 16384, 13 + 2 primes < 2^29, T = 65537): encode + encrypt,
   ``rescale(mul_relin(a, b))``, decrypt + decode, every slot checked
   against numpy's a*b mod T; the kernels' launch counts are zeroed just
   before and read just after, and every distinct kernel call of that run
   is held against the plain version on its own input; then the step is
   timed after a warm-up and profiled once;
4. the card's name and power limit as nvidia-smi gives them, the
   kernels' JSON line, and the result line.

Needs one CUDA card, ``nvcc`` and the repository beside this file; imports
nothing of JAX.
"""

from __future__ import annotations

import json
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


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


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
    logs = build.build(["ntt_mxu"])
    secs = time.perf_counter() - t0
    regs = sorted({ln.split("Used ")[1].split(",")[0] for log in logs.values()
                   for ln in log.splitlines() if "Used " in ln})
    print(f"phase 1 build: ntt_mxu.cu in {secs:.2f} s (ptxas: {'; '.join(regs)})")


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
    print("phase 2 kernels: bit-equal to the plain version (lazy, not lazy, "
          "limb offset 5), NTT->INTT identity; at "
          f"{BATCH}x{len(q + p)}x{ring.n}: " + ", ".join(
              f"{r['name']} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']})" for r in rows))
    return rows


def phase_server(rows):
    import numpy as np
    import torch
    from lattigo_tpu_torch import rlwe
    from lattigo_tpu_torch.presets import bgv_tpu_params
    from lattigo_tpu_torch.ring import ntt_mxu
    from lattigo_tpu_torch.schemes import bgv

    t0 = time.perf_counter()
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
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED)
    a = rng.integers(0, params.t, (BATCH, params.n))
    b = rng.integers(0, params.t, (BATCH, params.n))

    def serve():
        ca = encryptor.encrypt(gen, encoder.encode(a), batch=(BATCH,))
        cb = encryptor.encrypt(gen, encoder.encode(b), batch=(BATCH,))
        out = ev.rescale(ev.mul_relin(ca, cb))
        return ca, cb, encoder.decode(decryptor.decrypt(out))

    # record the first input of every distinct kernel call of the main path
    calls = {}
    launch = ntt_mxu.four_step_cuda

    def recording(eng, x, limb_lo, inverse, lazy):
        key = (id(eng), tuple(x.shape), limb_lo, inverse, lazy)
        if key not in calls:
            calls[key] = (eng, x.clone(), limb_lo, inverse, lazy)
        return launch(eng, x, limb_lo, inverse, lazy)

    ntt_mxu.four_step_cuda = recording
    try:
        ntt_mxu.reset_launches()
        ca, cb, got = serve()
        torch.cuda.synchronize()
        launches = dict(ntt_mxu.LAUNCHES)
    finally:
        ntt_mxu.four_step_cuda = launch
    check(np.array_equal(got, a * b % params.t), "decoded slots != a*b mod t")
    for r in rows:
        inverse = r["name"].endswith("inverse")
        r["launches"] = launches["inverse" if inverse else "forward"]
        check(r["launches"] > 0, f"{r['name']} not launched on the main path")
    # each kernel against its plain version at the main path's own calls
    for eng, x, limb_lo, inverse, lazy in calls.values():
        k = launch(eng, x, limb_lo, inverse, lazy)
        want = ntt_mxu.four_step_plain(eng, x, limb_lo, inverse, lazy)
        for r in rows:
            if r["name"].endswith("inverse") == inverse:
                r["max_abs_err"] = max(r["max_abs_err"], int((k - want).abs().max()))
        check(torch.equal(k, want), f"kernel != plain at main-path call "
              f"{tuple(x.shape)} limb_lo={limb_lo} inverse={inverse}")
    shapes = sorted({(tuple(x.shape), lo, "inv" if inv else "fwd")
                     for _, x, lo, inv, _ in calls.values()})

    def step():
        return ev.rescale(ev.mul_relin(ca, cb))

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
    print("phase 3 profile: " + profile_step(step))


def profile_step(step) -> str:
    """Device time of one step by kernel family, and the device's idle share
    of the step's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev, launches = {}, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            dev[ev.key] = ev.self_device_time_total
            launches += ev.count
    total = sum(dev.values())
    if total == 0:
        return "not measured (no device time in the trace)"
    ntt = sum(v for k, v in dev.items() if "ntt_mxu_kernel" in k)
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:3]
    return (f"wall {wall_us:.0f} us, {launches} device kernels busy {total:.0f} us "
            f"(idle share {max(0.0, 1 - total / wall_us):.3f}), ntt_mxu kernels "
            f"{ntt:.0f} us ({ntt / total:.3f} of device time); top: " + "; ".join(
                f"{k[:50]} {v:.0f} us" for k, v in top))


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
    phase_server(rows)
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
