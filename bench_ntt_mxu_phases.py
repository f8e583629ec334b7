#!/usr/bin/env python3
"""Where the four-step kernel's logN 15-16 cluster blocks spend their clocks.

    python3 bench_ntt_mxu_phases.py [--tree DIR]

Copies ``lattigo_tpu_torch`` of DIR (default: this script's directory) into
its gitignored ``_build/phases/``, adds clock64 counters to the copy's
``csrc/ntt_mxu.cu`` (its ``ntt_mxu_cluster_kernel``: the entry digits, step
1, the barrier between the steps, step 2; and for each job of each
consumer group its products, the part of them spent waiting for weight
tiles, and its epilogue), builds the copy, runs one forward call at the
three shapes of ``chip_smoke.WIDE_SHAPES`` at the cluster size the rule
picks, and prints one JSON line: per shape the mean over blocks, in
kilocycles of the SM clock. The copy's output is held against the plain
version first. The counters are written once per job (no read in the
timed loops), and each clock read is ordered against the kernel's
barriers and waits. The patch finds its places by the kernel's source
text, and fails if that text changed. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import chip_smoke

HERE = Path(__file__).resolve().parent

# (anchor in csrc/ntt_mxu.cu, text put in its place)
PATCHES = [
    ("namespace {\n", """__device__ unsigned long long g_phase[4096 * 64];
namespace {
__device__ __forceinline__ long long clk() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
  return t;
}
// slot of block b: 0 entry, 1 step 1, 2 barrier, 3 step 2; 4 + 3 * (6 * g
// + job of the group) + (0 products, 1 tile waits, 2 epilogue)
__device__ __forceinline__ void record(int slot, long long v) {
  if (blockIdx.x < 4096 && (threadIdx.x & 127) == 0)
    g_phase[blockIdx.x * 64 + slot] = static_cast<unsigned long long>(v);
}
"""),
    ("    if (jb > 0) bar_sync(2 + w);\n",
     "    if (jb > 0) bar_sync(2 + w);\n    const long long p0 = clk();\n"
     "    long long waits = 0;\n"),
    ("      mbar_wait(full + 8 * slot, (t / kStages) & 1);\n",
     "      const long long w0 = clk();\n"
     "      mbar_wait(full + 8 * slot, (t / kStages) & 1);\n"
     "      waits += clk() - w0;\n"),
    ("    wgmma_wait<0>();\n", "    wgmma_wait<0>();\n    const long long p1 = clk();\n"),
    ("      epilogue2<Sh>(acc, jb, c);\n",
     "      epilogue2<Sh>(acc, jb, c);\n"
     "    const int slot = 4 + 3 * (6 * (threadIdx.x >> 7) + (STEP - 1) * 3 + jb / kGroups);\n"
     "    record(slot, p1 - p0);\n    record(slot + 1, waits);\n"
     "    record(slot + 2, clk() - p1);\n"),
    ("  digitize<Sh>(cluster_smem, c);\n  asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n  __syncthreads();\n",
     "  const long long e0 = clk();\n"
     "  digitize<Sh>(cluster_smem, c);\n  asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n  __syncthreads();\n"
     "  const long long e1 = clk();\n  if (threadIdx.x == 0) record(0, e1 - e0);\n"),
    ("    consume<Sh, 1>(in, w, 0, ring, full, empty, c);\n"
     "    // step 1's digits reached every block of the cluster before step 2\n"
     "    asm volatile(\"fence.proxy.async.shared::cluster;\\n\" ::: \"memory\");\n"
     "    cluster_arrive();\n    cluster_wait();\n",
     "    consume<Sh, 1>(in, w, 0, ring, full, empty, c);\n"
     "    const long long s1 = clk();\n"
     "    // step 1's digits reached every block of the cluster before step 2\n"
     "    asm volatile(\"fence.proxy.async.shared::cluster;\\n\" ::: \"memory\");\n"
     "    cluster_arrive();\n    cluster_wait();\n"
     "    const long long s2 = clk();\n"),
    ("    consume<Sh, 2>(mid, w, base2, ring, full, empty, c);\n",
     "    consume<Sh, 2>(mid, w, base2, ring, full, empty, c);\n"
     "    if (threadIdx.x == 0) {\n      record(1, s1 - e1);\n      record(2, s2 - s1);\n"
     "      record(3, clk() - s2);\n    }\n"),
]


def instrumented_copy(tree: Path) -> Path:
    """``tree/lattigo_tpu_torch`` copied into its ``_build/phases`` with the
    counters added; returns the directory to import it from."""
    src = tree / "lattigo_tpu_torch"
    dst = src / "_build" / "phases"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst / "lattigo_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = dst / "lattigo_tpu_torch" / "csrc" / "ntt_mxu.cu"
    text = cu.read_text()
    for anchor, new in PATCHES:
        if text.count(anchor) != 1:
            raise RuntimeError(f"csrc/ntt_mxu.cu changed: {anchor.strip()[:60]!r} "
                               f"found {text.count(anchor)} times")
        text = text.replace(anchor, new)
    cu.write_text(text + """
extern "C" int ntt_mxu_phases(void* host, int bytes) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_phase, bytes));
}
""")
    return dst


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=HERE)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_ntt_mxu_phases: no CUDA device", file=sys.stderr)
        return 1
    root = instrumented_copy(args.tree.resolve())
    sys.path.insert(0, str(root))
    from lattigo_tpu_torch import build
    from lattigo_tpu_torch.presets import bgv_tpu_params
    from lattigo_tpu_torch.ring import ntt_mxu
    from lattigo_tpu_torch.ring.ring import Ring
    from lattigo_tpu_torch.rlwe.params import gen_moduli
    if not Path(ntt_mxu.__file__).resolve().is_relative_to(root):
        raise RuntimeError("lattigo_tpu_torch imported from outside the copy")
    lib = build.load("ntt_mxu")
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    out = []
    for polys, log_n, log_qp, limbs in chip_smoke.WIDE_SHAPES:
        lit = bgv_tpu_params(log_n, log_qp)
        q, p = gen_moduli(log_n, 2 << log_n, lit.log_q, lit.log_p)
        ring = Ring(1 << log_n, (q + p)[:limbs], device="cuda")
        eng = ring._mxu
        x = torch.randint(0, 1 << 62, (polys, len(ring.moduli), ring.n),
                          generator=gen, device="cuda") % ring.q
        chip_smoke.check(torch.equal(ntt_mxu.four_step_cuda(eng, x, 0, False, False),
                                     ntt_mxu.four_step_plain(eng, x, 0, False, False)),
                         f"instrumented kernel != plain at {tuple(x.shape)}")
        ntt_mxu.four_step_cuda(eng, x, 0, False, False)
        torch.cuda.synchronize()
        buf = np.zeros(4096 * 64, dtype=np.uint64)
        if lib.ntt_mxu_phases(ctypes.c_void_p(buf.ctypes.data), ctypes.c_int(buf.nbytes)):
            raise RuntimeError("could not read the counters")
        size = eng.split_for(x.numel() // eng.n, False)
        g = size * (1 << 14) // eng.n
        blocks = min(4096, x.shape[1] * -(-polys // g) * size)
        d = buf.reshape(4096, 64)[:blocks].astype(np.float64) / 1e3
        jobs = d[:, 4:58].reshape(blocks, 3, 2, 3, 3)       # group, step, job, metric
        ran = jobs[..., 0] > 0                              # group 2 has two jobs a step
        per_job = {f"step{s + 1}": {m: float(jobs[:, :, s, :, i][ran[:, :, s, :]].mean())
                                    for i, m in enumerate(("products", "tile_waits",
                                                           "epilogue"))}
                   for s in range(2)}
        out.append(dict(shape=list(x.shape), cluster=size, blocks=blocks,
                        entry=float(d[:, 0].mean()), step1=float(d[:, 1].mean()),
                        barrier=float(d[:, 2].mean()), step2=float(d[:, 3].mean()),
                        per_job=per_job))
        del ring, eng, x
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": smi, "unit": "kilocycles a block (mean)", "shapes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
