"""Bootstrap driver: the counterpart of the JAX package's
``bench_bootstrap.py``, with its presets and arguments.

One full CKKS bootstrap set up and run on one device (the CUDA card unless
named), measured, and printed as one JSON line. It is a driver, not the
benchmark: it writes no file.

    python3 bench_bootstrap_torch.py [log_n] [batch]
    python3 bench_bootstrap_torch.py --preset NAME [batch] [--log-n K] [--once]
    ... [--device cpu]

``log_n`` builds ``bench_bootstrap.py``'s own chain (Q 55 + 3 x 45, P 2 x
60, H = 192 with an H = 32 ephemeral secret, three C2S and three S2C
levels); ``--preset`` one of the published sets of
:mod:`~lattigo_tpu_torch.circuits.bootstrapping_presets`, ``--log-n`` at a
reduced ring degree. The JSON line carries:

* ``value``: seconds per bootstrap (per ciphertext of the batch), the
  median of 3 windows of 3 bootstraps (``--once``: one window of one), each
  bootstrap's input made from the previous output so that none can start
  early; ``spread`` is the slowest window over the fastest (a warning on
  stderr at ≥ 1.3);
* ``stage_ms``: one more bootstrap, the only one the program's tracer
  (:mod:`lattigo_tpu_torch.trace`) runs for, timed by its stage spans:
  ScaleDown (with the encapsulation switches and ModUp), C2S, EvalMod
  (both halves), S2C;
* ``first_s`` (the first, untimed bootstrap, which builds the engines' host
  tables) and ``setup_s`` (parameters, keys and DFT matrices);
* ``precision_bits`` / ``precision_avg_bits``: worst and mean bits of the
  decoded slots against the encrypted ones;
* ``peak_mib``: the device's peak allocated memory over the run (CUDA only).

Times on the card come from CUDA events read after a synchronize; on the
CPU from the host clock. Under the tracer the card also reports each
synchronizing call, which slows a stage the host paces.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from dataclasses import replace

import torch

from lattigo_tpu_torch import trace
from lattigo_tpu_torch.device import resolve_device

#: the stages of ``stage_ms``: (name, the bootstrap's span)
STAGES = (("ScaleDown", "btp.scaledown"), ("C2S", "btp.c2s"),
          ("EvalMod", "btp.evalmod"), ("S2C", "btp.s2c"))
SPREAD_WARN = 1.3


class _Clock:
    """A window on the device's timeline: CUDA events on the card (read
    after one synchronize), the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.t0 = self._now()

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self) -> float:
        """ms from the clock's start to now."""
        t1 = self._now()
        if self.cuda:
            torch.cuda.synchronize()
            return self.t0.elapsed_time(t1)
        return (t1 - self.t0) * 1e3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def parameters(log_n: int = 13, preset: str | None = None,
               preset_log_n: int | None = None):
    """(name, residual literal, bootstrapping literal) of the run: a
    published preset (at ``preset_log_n`` when given), else
    ``bench_bootstrap.py``'s chain at ``log_n``."""
    from lattigo_tpu_torch.circuits import bootstrapping_presets as bp
    from lattigo_tpu_torch.ring.sampling import Ternary
    from lattigo_tpu_torch.schemes import ckks

    if preset is not None:
        residual, lit = getattr(bp, preset)
        if preset_log_n is not None:
            residual = replace(residual, log_n=preset_log_n)
        return preset, residual, lit
    residual = ckks.ParametersLiteral(
        log_n=log_n, log_q=(55, 45, 45, 45), log_p=(60, 60),
        log_default_scale=45, xs=Ternary(hamming_weight=192))
    lit = bp.BootstrappingLiteral(
        c2s_log_scales=[[56], [56], [56]], s2c_log_scales=[[39], [39], [39]],
        evalmod_log_scale=60)
    return f"logN{log_n}", residual, lit


def run(log_n: int = 13, batch: int = 1, preset: str | None = None,
        preset_log_n: int | None = None, once: bool = False, device=None,
        seed: int = 0) -> dict:
    """Set up, bootstrap and measure (see the module's docstring); returns
    the JSON line's fields. The set-up is the presets' own
    :func:`~lattigo_tpu_torch.circuits.bootstrapping_presets.prepare_recipe`
    with ``seed`` (keys and encryption from ``torch.Generator``s, the slots
    from numpy's seed 1)."""
    from lattigo_tpu_torch.circuits import bootstrapping_presets as bp

    device = resolve_device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    name, residual, lit = parameters(log_n, preset, preset_log_n)
    t0 = time.perf_counter()
    r = bp.prepare_recipe((residual, lit), log_n=preset_log_n if preset else None,
                          seed=seed, device=device, batch=batch)
    params, b, keys, ct, v = r["params"], r["evaluator"], r["keys"], r["ct"], r["slots"]
    _sync(device)
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    b.bootstrap(ct, keys)
    _sync(device)
    first_s = time.perf_counter() - t0

    # each input carries a zero made from the previous output, so that no
    # bootstrap of a window starts before the one before it has ended
    windows, iters = (1, 1) if once else (3, 3)
    times = []
    for _ in range(windows):
        cur = ct
        clock = _Clock(device)
        for _ in range(iters):
            out = b.bootstrap(cur, keys)
            cur = ct.replace(value=ct.value + out.value.reshape(-1)[:1] * 0)
        times.append(clock.ms() / 1e3 / iters / batch)
    per = statistics.median(times)
    spread = max(times) / min(times)
    if spread >= SPREAD_WARN:
        print(f"# warning: window spread {spread:.2f} >= {SPREAD_WARN}: rerun for "
              "a stable number", file=sys.stderr)

    trace.start(cuda)
    out = b.bootstrap(ct, keys)
    spans = trace.stop()["spans"]
    stage_ms = {k: spans[name]["device_ms" if cuda else "host_ms"] for k, name in STAGES}
    out0 = out if batch == 1 else out.replace(value=out.value[0])
    worst, avg = bp.precision_bits(r["decode"](out0), v)
    peak = torch.cuda.max_memory_allocated(device) / 2**20 if cuda else None
    return {
        "metric": f"ckks_bootstrap_{name}", "value": per, "unit": "s/bootstrap",
        "batch": batch, "log_n": params.log_n, "slots": params.max_slots,
        "setup_s": setup_s, "first_s": first_s,
        "precision_bits": worst, "precision_avg_bits": avg,
        "windows": windows, "iters": iters, "spread": spread,
        "stage_ms": stage_ms, "peak_mib": peak,
        "engine": params.ring_q.ntt_engine,
        "device": {"platform": device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu"},
    }


def main(argv=None) -> int:
    """``bench_bootstrap.py``'s command line, plus ``--device``."""
    ap = argparse.ArgumentParser(description="One CKKS bootstrap, measured.")
    ap.add_argument("args", nargs="*", help="[log_n] [batch], or [batch] with --preset")
    ap.add_argument("--preset", default=None, help="a published preset's name")
    ap.add_argument("--log-n", type=int, default=None, dest="log_n",
                    help="the preset at a reduced ring degree")
    ap.add_argument("--once", action="store_true", help="one timed bootstrap")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run there)")
    a = ap.parse_args(argv)
    pos = [int(x) for x in a.args]
    if a.preset is not None:
        res = run(batch=pos[0] if pos else 1, preset=a.preset,
                  preset_log_n=a.log_n, once=a.once, device=a.device)
    else:
        if a.log_n is not None:
            ap.error("--log-n only applies with --preset; pass the ring degree "
                     "positionally: [log_n] [batch]")
        res = run(pos[0] if pos else 13, pos[1] if len(pos) > 1 else 1,
                  once=a.once, device=a.device)
    print(json.dumps(res), flush=True)
    return 0
