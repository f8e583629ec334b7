#!/usr/bin/env python3
"""Time the four-step NTT kernel (``csrc/ntt_mxu.cu``) of a checkout on one CUDA card.

    python3 bench_ntt_mxu.py [--tree DIR]

Imports ``lattigo_tpu_torch`` from DIR (default: the directory of this
script), builds its four-step kernel and prints one JSON line with:

* ``bulk``, per direction at 4 x 15 x 16384 (the BGV chain's 15 primes):
  CUDA-event ms per call over 50 calls after a warm-up (``ms``), the
  kernel's device us per launch from ``torch.profiler`` over as many
  launches (``device_us``), and the blocks per (limb, polynomial) the tree
  picks (``split``; null for trees that have one block per pair);
* ``wide``: the same at the logN 15 and 16 shapes of ``chip_smoke.py``'s
  phase 2 (4 x 31 x 32768, 2 x 62 x 65536 and 256 x 1 x 65536; ``split``
  is the cluster size in trees that run these on clusters, ``device_us``
  is per launch and ``launches_per_call`` says how many a call makes:
  two in trees that run one launch a step), for trees whose kernel has
  them;
* ``path``: the same for every distinct call of one BGV request
  (``chip_smoke.bgv_server``: encrypt, ``rescale(mul_relin)``, decrypt),
  with its shape, limb offset and direction;
* in each of those rows, ``splits`` (trees with a ``split`` argument):
  device us per launch for every split the kernel has at that shape;
* ``step``: one profiled BGV step (``rescale(mul_relin)``), the kernel
  family's device us and launches in it, the step's device-busy us and
  the device's idle share;
* ``cublas_int8_products``: as a yardstick for the products alone, one
  ``torch._int_mm`` (cuBLAS int8) per contraction and limb at the bulk
  shape, the same multiply-adds as one forward call's two contractions
  without digits, recombination, twiddles or the int64 traffic (event
  ms of the 30 calls, their summed device us): not the kernel's
  function, so no library time of the kernel.

Every kernel output is held bit for bit against the plain version first.
To compare two versions, run it on both trees on the same card, in turns
(parent, change, change, parent). Takes its timers and the BGV server from
``chip_smoke.py`` beside it; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke

HERE = Path(__file__).resolve().parent
REPS = 50


def device_us(fn, reps: int = REPS, tries: int = 3) -> float:
    """Device microseconds per launch of the four-step kernels over reps
    calls of fn, from torch.profiler (a session that comes back with no
    device activity, as one of many in a process sometimes does, is
    repeated up to ``tries`` times)."""
    for _ in range(tries):
        _, family = chip_smoke.profile_step(
            lambda: [fn() for _ in range(reps)], host=False)
        if family:
            return (sum(us for us, _ in family.values())
                    / sum(n for _, n in family.values()))
    raise RuntimeError(f"no four-step kernel in {tries} profiles")


def int_mm(eng, polys: int) -> dict:
    """One torch._int_mm per contraction and limb of a forward call on
    [polys, limbs, N]: W1f [4R, 4R] @ digits [4R, polys C] and digits
    [polys R, 4C] @ W2f [4C, 4C]. CUDA-event ms of all of them, and their
    device us summed over every kernel of one such round (profiler)."""
    import torch
    r, c, limbs = eng.rr, eng.cc, eng.consts.shape[0]
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)

    def digits(m, k):
        return torch.randint(-128, 128, (m, k), generator=g, device="cuda",
                             dtype=torch.int8)

    # A row-major, B column-major (W2f is w2f_t transposed)
    d1, d2 = digits(polys * c, 4 * r).t(), digits(polys * r, 4 * c)

    def products():
        for i in range(limbs):
            torch._int_mm(eng.w1f[i], d1)
            torch._int_mm(d2, eng.w2f_t[i].t())

    _, kernels = chip_smoke.profile_step(products, kernel="", host=False)
    return dict(ms=chip_smoke.cuda_ms(products, 20), calls=2 * limbs,
                device_us=sum(us for us, _ in kernels.values()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=HERE)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_ntt_mxu: no CUDA device", file=sys.stderr)
        return 1
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import lattigo_tpu_torch
    from lattigo_tpu_torch.presets import bgv_tpu_params
    from lattigo_tpu_torch.ring import ntt_mxu
    from lattigo_tpu_torch.ring.ring import Ring
    from lattigo_tpu_torch.rlwe.params import gen_moduli
    if Path(lattigo_tpu_torch.__file__).resolve().parent.parent != tree:
        raise RuntimeError("lattigo_tpu_torch imported from outside --tree")
    launch = ntt_mxu.four_step_cuda
    has_split = "split" in inspect.signature(launch).parameters

    def measure(eng, x, limb_lo, inverse, lazy):
        def fn():
            return launch(eng, x, limb_lo, inverse, lazy)
        chip_smoke.check(torch.equal(fn(), ntt_mxu.four_step_plain(
            eng, x, limb_lo, inverse, lazy)), f"kernel != plain at {tuple(x.shape)}")
        row = dict(shape=list(x.shape), limb_lo=limb_lo,
                   dir="inverse" if inverse else "forward", lazy=lazy,
                   split=(eng.split_for(x.numel() // eng.n, inverse)
                          if has_split else None),
                   launches_per_call=getattr(eng, "launches_per_call", 1),
                   ms=chip_smoke.cuda_ms(fn, REPS), device_us=device_us(fn))
        if has_split:
            row["splits"] = {}
            for s in getattr(eng, "splits", ntt_mxu.SPLITS):
                if s <= eng.max_split(inverse):
                    def fs(s=s):
                        return launch(eng, x, limb_lo, inverse, lazy, split=s)
                    chip_smoke.check(torch.equal(fs(), fn()), f"split {s} differs")
                    row["splits"][s] = device_us(fs)
        return row

    lit = bgv_tpu_params(chip_smoke.LOG_N, chip_smoke.LOG_QP)
    q, p = gen_moduli(chip_smoke.LOG_N, 2 << chip_smoke.LOG_N, lit.log_q, lit.log_p)
    ring = Ring(1 << chip_smoke.LOG_N, q + p, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    x = torch.randint(0, 1 << 62, (chip_smoke.BATCH, len(q + p), ring.n),
                      generator=gen, device="cuda") % ring.q
    bulk = {("inverse" if inv else "forward"): measure(ring._mxu, x, 0, inv, False)
            for inv in (False, True)}
    wide = []
    for polys, log_n, log_qp, limbs in (chip_smoke.WIDE_SHAPES
                                        if ntt_mxu.MAX_N >= 1 << 16 else ()):
        lit_w = bgv_tpu_params(log_n, log_qp)
        qw, pw = gen_moduli(log_n, 2 << log_n, lit_w.log_q, lit_w.log_p)
        ring_w = Ring(1 << log_n, (qw + pw)[:limbs], device="cuda")
        xw = torch.randint(0, 1 << 62, (polys, len(ring_w.moduli), ring_w.n),
                           generator=gen, device="cuda") % ring_w.q
        wide += [measure(ring_w._mxu, xw, 0, inv, False) for inv in (False, True)]
        del ring_w, xw
        torch.cuda.empty_cache()

    params, a, b, serve, step_of = chip_smoke.bgv_server()
    (ca, cb, got), calls, _ = chip_smoke.record_calls(ntt_mxu, "four_step_cuda", serve)
    import numpy as np
    chip_smoke.check(np.array_equal(got, a * b % params.t), "decoded slots != a*b mod t")
    path = [measure(*c) for c in calls.values()]
    for _ in range(3):
        step_of(ca, cb)
    text, family = chip_smoke.profile_step(lambda: step_of(ca, cb))
    step = dict(profile=text,
                ntt_mxu_device_us=sum(us for us, _ in family.values()),
                ntt_mxu_launches=sum(n for _, n in family.values()))
    try:
        cublas = int_mm(ring._mxu, chip_smoke.BATCH)
    except RuntimeError as e:            # shapes cuBLAS refuses: say so
        cublas = f"not measured: {e}"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"tree": str(tree), "card": smi, "bulk": bulk, "wide": wide,
                      "path": path, "step": step, "cublas_int8_products": cublas}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
