#!/usr/bin/env python3
"""Time the u32 NTT kernel (``csrc/ntt_pallas.cu``) of a checkout on one CUDA card.

    python3 bench_ntt_u32.py [--tree DIR]

Imports ``lattigo_tpu_torch`` from DIR (default: the directory of this
script), builds its u32 kernel, holds it against its plain version at both
shapes below, and prints one JSON line with, per direction:

* ``ms_path`` and ``ms_bulk``: CUDA-event milliseconds per call at
  2 x 1 x 1024 (the blind rotation's shape, Q = 0x7fff801; 1000 calls)
  and at 4 x 15 x 16384 (15 alternating 29-bit primes; 20 calls), after
  a warm-up;
* ``device_us_path`` and ``device_us_bulk``: the kernel's device time per
  launch at each shape from ``torch.profiler`` (over as many launches as
  the event timing), which the event timing exceeds where the host's
  enqueueing is the slower of the two;
* ``host_us_per_call``: wall clock over 1000 back-to-back calls at
  2 x 1 x 1024 that end in one ``torch.cuda.synchronize()``;
* ``host_parts_us`` (forward, trees whose engine binds the kernel once):
  host microseconds of the pieces of one such call, each over 10000
  repetitions, and of one ``torch.add`` on the same tensor for scale.

To compare two versions, run it on both trees on the same card,
in turns (parent, change, change, parent). Takes its timers from
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
REPS = 1000


def device_us(fn, reps: int) -> float:
    """Device microseconds per launch of the u32 kernels over reps calls of
    fn, from torch.profiler."""
    _, family = chip_smoke.profile_step(lambda: [fn() for _ in range(reps)],
                                        kernel="ntt_u32_kernel", host=False)
    chip_smoke.check(bool(family), "no u32 kernel in the profile")
    return (sum(us for us, _ in family.values())
            / sum(n for _, n in family.values()))


def host_parts(ntt_pallas, eng, x) -> dict | None:
    import torch
    if not hasattr(type(eng), "_binding"):
        return None
    k = eng._binding
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(k.device).cuda_stream
    args = (x.data_ptr(), out.data_ptr(), k.ptr, 0, x.numel() // eng.n,
            x.shape[-2], 0, stream)
    parts = {
        "empty_like": lambda: torch.empty_like(x),
        "current_stream": lambda: torch.cuda.current_stream(k.device).cuda_stream,
        "raw_stream_private_api": lambda: torch._C._cuda_getCurrentRawStream(k.device),
        "ctypes_call_and_launch": lambda: k.fn(*args),
        "whole_call": lambda: ntt_pallas.u32_cuda(eng, x, 0, False, False),
        "torch_add": lambda: torch.add(x, x),
    }
    return {name: chip_smoke.host_us_per_call(fn, 10 * REPS)
            for name, fn in parts.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=HERE)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_ntt_u32: no CUDA device", file=sys.stderr)
        return 1
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import lattigo_tpu_torch
    from lattigo_tpu_torch.ring import ntt_pallas
    from lattigo_tpu_torch.ring.ring import Ring
    from lattigo_tpu_torch.utils.primes import NTTFriendlyPrimesGenerator
    if Path(lattigo_tpu_torch.__file__).resolve().parent.parent != tree:
        raise RuntimeError("lattigo_tpu_torch imported from outside --tree")

    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    shapes = {
        "path": (Ring(1024, [0x7FFF801], device="cuda"), (2,), REPS),
        "bulk": (Ring(1 << 14, NTTFriendlyPrimesGenerator(29, 1 << 15)
                      .next_alternating_primes(15), device="cuda"), (4,), 20),
    }
    res = {}
    for inverse in (False, True):
        row = {}
        for tag, (ring, batch, reps) in shapes.items():
            eng = ring._u32
            x = torch.randint(0, 1 << 62, batch + (len(ring.moduli), ring.n),
                              generator=gen, device="cuda") % ring.q

            def fn():
                return ntt_pallas.u32_cuda(eng, x, 0, inverse, False)

            if not torch.equal(fn(), ntt_pallas.u32_plain(eng, x, 0, inverse, False)):
                raise RuntimeError(f"kernel != plain at {tuple(x.shape)}")
            row[f"ms_{tag}"] = chip_smoke.cuda_ms(fn, reps)
            row[f"device_us_{tag}"] = device_us(fn, reps)
            if tag == "path":
                row["host_us_per_call"] = chip_smoke.host_us_per_call(fn, REPS)
                if not inverse:
                    row["host_parts_us"] = host_parts(ntt_pallas, eng, x)
        res["inverse" if inverse else "forward"] = row
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"tree": str(tree), "card": smi, "u32": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
