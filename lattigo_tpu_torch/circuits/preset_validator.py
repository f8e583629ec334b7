"""Preset validator: the counterpart of the JAX package's
``validate_presets.py``, with its arguments, default list and line.

    python3 validate_presets_torch.py [preset ...] [--log-n 9] [--device cpu]

Each preset's exact chain, EvalMod and DFT factorization runs end to end
at a reduced ring degree (default logN 9) through
:func:`~lattigo_tpu_torch.circuits.bootstrapping_presets.run_recipe`, and
one line a preset reports its worst-slot and mean precision. The ring
degree scales only the DFT gain and the RLWE noise (~√N), so a recipe that
is structurally broken (scale plumbing, matrix quantisation, message-ratio
bookkeeping) is loud at logN 9.
"""

from __future__ import annotations

import argparse
import time

from lattigo_tpu_torch.device import resolve_device

#: ``validate_presets.py``'s default list, in its order
DEFAULT_PRESETS = ("N15QP768_H192_H32", "N16QP1546_H192_H32",
                   "N16QP1547_H192_H32", "N16QP1553_H192_H32",
                   "N16QP1767_H32768_H32", "N16QP1788_H32768_H32",
                   "N16QP1793_H32768_H32", "N15QP880_H16384_H32")


def validate(name: str, log_n: int = 9, device=None) -> tuple[float, float, float]:
    """Run ``name``'s recipe at ``log_n`` and print its line (the reference
    quotes the mean per-slot precision, so both are given). Returns
    (worst bits, mean bits, seconds)."""
    from lattigo_tpu_torch.circuits import bootstrapping_presets as bp

    t0 = time.time()
    prec, prec_avg = bp.run_recipe(getattr(bp, name), log_n, device=device)
    s = time.time() - t0
    print(f"{name} @ logN={log_n}: {prec:.1f} bits worst-slot / "
          f"{prec_avg:.1f} avg ({s:.0f}s)", flush=True)
    return prec, prec_avg, s


def main(argv=None) -> dict:
    """``validate_presets.py``'s command line, plus ``--device``; returns
    {preset: (worst, mean, seconds)}."""
    ap = argparse.ArgumentParser(description="Validate the published bootstrap "
                                             "presets at a reduced ring degree.")
    ap.add_argument("presets", nargs="*", help="preset names (default: all eight)")
    ap.add_argument("--log-n", type=int, default=9, dest="log_n")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run there)")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    return {name: validate(name, a.log_n, device)
            for name in (a.presets or DEFAULT_PRESETS)}
