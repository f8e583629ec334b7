"""One run of one cell of the benchmark of ``lattigo_tpu_torch``.

    python3 -m hebench --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``. The cell names
a configuration (``hebench/configs/<config>.json``) and a traffic mix
(``hebench/traffic/<traffic>.json``), whose ``kind`` names the request
code (``hebench/kinds/<kind>.py``); the limits of its check are in
``hebench/limits/<cell>.json`` and each metric's reader in
``hebench/metrics/<metric>.py``.

A run: set-up (parameters, keys, inputs from ``--seed``, one warm request),
then a closed loop of one client for ``--seconds`` (whole requests: the
window ends with the first request that ends after it), then, with
``--trace 1``, a count of aten ops where a metric needs it and three
stretches of the same requests (unprofiled, for the wall; device activity
profiled, for busy time and kernel families; host and device profiled,
for the idle gaps' labels), then the check of a seeded sample of the window's outputs against the NumPy
reference. The last line of standard output is the result; the numbers
compared, each with its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
#: top-level modules that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "lattigo_tpu")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def reader(name: str):
    """The metric's reader module (``hebench/metrics/<name>.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"hebench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, key: str, cell: str) -> list[dict]:
    """The metrics of ``bench[key]`` that the cell reports."""
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def check_outputs(samples, sk_coeffs, moduli, limits: dict, failed: int) -> dict:
    """The numbers compared, each {"value", "limit"}: requests that raised,
    outputs of the wrong shape or level, residues no small integer
    explains, the slots' worst error (log2) against the reference's
    answers, and how many ciphertexts were decrypted."""
    from hebench.reference import ckks as ref

    sk = ref.SecretKey(sk_coeffs, moduli)
    n = len(sk_coeffs)
    wrong = mismatch = checked = 0
    worst = 0.0
    for s in samples:
        v = s["value"]
        checked += 1
        if v.ndim != 3 or v.shape[0] != 2 or v.shape[-1] != n or v.shape[1] != s["level"] + 1:
            wrong += 1
            continue
        r = ref.judge(v, s["is_ntt"], s["is_montgomery"], s["scale"], sk, s["want"])
        mismatch += r["crt_mismatch"]
        worst = max(worst, r["max_err"])
    err_log2 = math.log2(worst) if 0 < worst < math.inf else (-1024.0 if worst == 0 else 1024.0)
    return {
        "failed_requests": {"value": failed, "limit": 0},
        "wrong_shape": {"value": wrong, "limit": 0},
        "crt_mismatch": {"value": mismatch, "limit": 0},
        "max_err_log2": {"value": err_log2, "limit": limits["max_err_log2"]},
        "unchecked": {"value": int(checked < limits["min_checked"]), "limit": 0},
    }


def run_cell(cfg: dict, traffic: dict, limits: dict, seed: int, seconds: float,
             trace_on: bool, device: str, t_start: float,
             e2e: list[dict], per_layer: list[dict]) -> dict:
    """Set up, warm, measure, check; returns the result's fields."""
    import torch
    from hebench.trace import Trace, count_ops, profile

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    trace = Trace(trace_on, cuda)
    kind = importlib.import_module(f"hebench.kinds.{traffic['kind']}")
    cell = kind.Cell(cfg, traffic, seed, device, trace)
    sync()
    t_warm = time.perf_counter()
    cell.request(-1)                     # warm: every shape the window runs
    sync()

    lat, issue = [], []
    failed, first_error = 0, None
    i = 0
    setup_s = time.perf_counter() - t_start
    trace.recording = trace_on
    with trace.transforms():
        t_w0 = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            out = None
            try:
                out = cell.request(i)
                t_iss = time.perf_counter()
                sync()
            except Exception as exc:     # a request that raises is a failed answer
                failed += 1
                first_error = first_error or repr(exc)
                t_iss = time.perf_counter()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            issue.append(t_iss - t0)
            if out is not None:
                cell.keep(i, out)
            i += 1
            if t1 - t_w0 >= seconds:
                break
    window_s = t1 - t_w0
    trace.recording = False
    peak = torch.cuda.max_memory_allocated() if cuda else None

    rec = SimpleNamespace(
        requests=i, ct=i * cell.ct_per_request,
        window_s=window_s, latencies_s=lat, issue_s=issue, setup_s=setup_s,
        peak_bytes=peak, key_mem_bytes=cell.key_mem_bytes, span_ms={}, ntt={},
        profile={}, ops_per_ct=None)
    if trace_on:
        rec.span_ms = trace.span_ms()
        rec.ntt = trace.ntt_totals()
        if any(getattr(reader(m["name"]), "NEEDS_OPS", False) for m in per_layer):
            ops = count_ops(lambda: cell.request(i))
            sync()
            rec.ops_per_ct = ops / cell.ct_per_request
        n_prof = traffic.get("profile_requests", 1)

        def stretch(at):
            for k in range(n_prof):
                cell.request(at + k)
                sync()
        sync()
        t_plain = time.perf_counter()
        stretch(i + 1)
        plain_s = time.perf_counter() - t_plain
        rec.profile = profile(lambda: stretch(i + 1 + n_prof), cuda, host=False)
        rec.profile["plain_s"] = plain_s
        labelled = profile(lambda: stretch(i + 1 + 2 * n_prof), cuda, host=True)
        rec.profile["idle_gaps"] = labelled["idle_gaps"]
        print(f"hebench: stretches of {n_prof} request(s): unprofiled {plain_s:.3f} s, "
              f"device profiled {rec.profile['window_s']:.3f} s (busy "
              f"{rec.profile['busy_s']:.3f} s), host and device profiled "
              f"{labelled['window_s']:.3f} s", file=sys.stderr)

    t_check = time.perf_counter()
    samples = list(cell.samples())
    sk_coeffs = cell.sk_coeffs
    del cell, out
    checks = check_outputs(samples, sk_coeffs, cfg["q"], limits, failed)
    if first_error:
        print(f"hebench: a request raised: {first_error}", file=sys.stderr)
    print(f"hebench: set-up {t_warm - t_start:.3f} s, warm request "
          f"{t_start + setup_s - t_warm:.3f} s, window {window_s:.3f} s "
          f"({i} requests), trace {t_check - t1:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s ({len(samples)} ciphertexts)",
          file=sys.stderr)

    metrics = {}
    for m in (per_layer if trace_on else e2e):
        v = reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": i, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak},
    }
    if trace_on:
        result["device"].update(busy_s=rec.profile["busy_s"],
                                window_s=rec.profile["window_s"])
        result["breakdown"] = {k: rec.profile[k] for k in ("device_ops", "idle_gaps")}
    result["checks"] = checks
    return result


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 -m hebench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    root = Path.cwd()
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if a.workload not in cells:
        print(f"hebench: no workload {a.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    w = cells[a.workload]
    cfg = load_json(HERE / "configs" / f"{w['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{a.workload}.json")
    cache = root / "hebench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"hebench: needs {w['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        importlib.import_module("lattigo_tpu_torch")
    except ImportError as exc:
        print(f"hebench: the program is not in this checkout: {exc}", file=sys.stderr)
        return 4
    res = run_cell(cfg, traffic, limits, a.seed, a.seconds, bool(a.trace), "cuda",
                   t_start, cell_metrics(bench, "end_to_end", a.workload),
                   cell_metrics(bench, "per_layer", a.workload))
    found = forbidden_modules()
    if found:
        print(f"hebench: loaded {found}: the run may not import them", file=sys.stderr)
        return 5
    res["device"]["power_limit"] = power_limit()
    res["checks"] = res.pop("checks")
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
