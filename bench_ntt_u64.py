#!/usr/bin/env python3
"""Time the u64 NTT kernel (``csrc/ntt_u64.cu``) of a checkout on one CUDA card.

    python3 bench_ntt_u64.py [--tree DIR]

Imports ``lattigo_tpu_torch`` from DIR (default: the directory of this
script), builds its u64 kernel, holds it against its plain version and
the u64 four-step engine at each shape below, and prints one JSON line
with, per shape and direction (non-lazy):

* ``ms``: CUDA-event milliseconds a call (two launches), after a warm-up;
* ``device_us``: the kernel's device microseconds a call (both passes),
  from ``torch.profiler``;
* ``plain_ms``: its plain version (:func:`ntt_u64.u64_plain`) on the card;
* ``mxu64_ms``: the u64 four-step engine (``NTTMxu64``, the transform these
  rings ran before the kernel) on the card;
* ``bytes_us``: each residue read and written once as int64 at 3.35 TB/s;
  ``ops_us``: the butterflies (N/2 · logN a row) at 14 IMAD-class
  instructions each at the card's int32 peak (``chip_smoke.u64_times``);
* ``roofline_pct``: ``bytes_us`` over ``device_us`` (``hebench``'s
  ``ntt_roofline``'s yardstick).

The shapes are the benchmark's, ``chip_smoke.U64_SHAPES``: 2 x 34 x 65536
(a ciphertext of the step at level 33), 16 x 1 x 65536 through
``intt_single`` (the rescale's last limb of 8 ciphertexts), 4 x 17 x 32768
(the bootstrap ring). To compare two versions, run it on both trees on the
same card, in turns. Takes its shapes, rings, bounds and timers from
``chip_smoke.py`` beside it; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke

HERE = Path(__file__).resolve().parent


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True
                          ).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=HERE)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_ntt_u64: no CUDA device", file=sys.stderr)
        return 1
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import lattigo_tpu_torch
    from lattigo_tpu_torch.ring import ntt_u64, ntt_u64_mxu
    from lattigo_tpu_torch.ring.ntt_u64 import LAUNCHES_PER_CALL
    if Path(lattigo_tpu_torch.__file__).resolve().parent.parent != tree:
        raise RuntimeError("lattigo_tpu_torch imported from outside --tree")

    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    res = {}
    for name, logn, bits, polys, single in chip_smoke.U64_SHAPES:
        ring = chip_smoke.u64_ring(logn, bits)
        chip_smoke.check(ring.ntt_engine == "u64-cuda", f"{name} on {ring.ntt_engine}")
        eng, n = ring._u64, ring.n
        mxu64 = ntt_u64_mxu.NTTMxu64(n, ring.moduli, [s.psi for s in ring.subrings], "cuda")
        lo = single or 0
        q = ring.q[lo:lo + 1] if single is not None else ring.q
        x = torch.randint(0, 1 << 62, (polys, q.shape[0], n), generator=gen,
                          device="cuda") % q
        bytes_us, ops_us = (t * 1e3 for t in chip_smoke.u64_times(tuple(x.shape)))
        row = dict(shape=list(x.shape), bytes_us=bytes_us, ops_us=ops_us)
        for inverse in (False, True):
            def fn():
                return ntt_u64.u64_cuda(eng, x, lo, inverse, False)

            def old():
                return mxu64._apply(x, slice(lo, lo + x.shape[-2]), inverse, False)

            got = fn()
            chip_smoke.check(torch.equal(got, ntt_u64.u64_plain(eng, x, lo, inverse, False)),
                             f"{name}: kernel != plain, inverse={inverse}")
            chip_smoke.check(torch.equal(got, old()), f"{name}: kernel != mxu64")
            _, family = chip_smoke.profile_step(lambda: [fn() for _ in range(20)],
                                                kernel="ntt_u64_", host=False)
            chip_smoke.check(len(family) == LAUNCHES_PER_CALL,
                             f"{name}: kernels {sorted(family)} in the profile")
            dev_us = sum(us / k for us, k in family.values())   # one launch of each pass
            row["inverse" if inverse else "forward"] = dict(
                ms=chip_smoke.cuda_ms(fn, 50), device_us=dev_us,
                plain_ms=chip_smoke.cuda_ms(
                    lambda: ntt_u64.u64_plain(eng, x, lo, inverse, False), 3),
                mxu64_ms=chip_smoke.cuda_ms(old, 3),
                roofline_pct=100 * bytes_us / dev_us)
        res[name] = row
        del mxu64
        torch.cuda.empty_cache()
    print(json.dumps({"tree": str(tree), "card": _smi("name,power.limit"),
                      "sm_mhz_max": float(_smi("clocks.max.sm").split()[0]), "u64": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
