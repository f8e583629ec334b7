"""Readings for the limits of a cell's check: the numbers compared, on
several seeds in one process, of the program as it is or of the control
(:mod:`hebench.control`), at the cell's own sizes and load.

    python3 -m hebench.calibrate --workload NAME --seeds 1,2,3 --seconds S [--control]

prints one JSON line a seed: {"seed", "control", "checks", "attempted"}.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import time
from pathlib import Path

from hebench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m hebench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    a = ap.parse_args(argv)

    import torch
    from hebench.control import float64_products

    bench = run.load_json(Path.cwd() / "BENCHMARK.json")
    w = {c["name"]: c for c in bench["workloads"]}[a.workload]
    cfg = run.load_json(run.HERE / "configs" / f"{w['config']}.json")
    traffic = run.load_json(run.HERE / "traffic" / f"{w['traffic']}.json")
    limits = run.load_json(run.HERE / "limits" / f"{a.workload}.json")
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in a.seeds.split(",")):
        ctx = float64_products() if a.control else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with ctx:
                res = run.run_cell(cfg, traffic, limits, seed, a.seconds, False,
                                   device, t0, [], [])
            line = {"checks": res["checks"], "attempted": res["attempted"],
                    "correct": res["correct"]}
        except Exception as exc:         # a control that crashes has failed
            line = {"error": repr(exc)[:500], "correct": False}
        print(json.dumps({"workload": a.workload, "seed": seed, "control": a.control,
                          **line}), flush=True)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
