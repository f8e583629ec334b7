"""The port stands alone: no module of lattigo_tpu_torch, and neither
chip_smoke.py nor interop.py, imports JAX or the JAX package; and an entry
point given no device runs on CUDA or raises, never silently on the CPU."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import lattigo_tpu_torch

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    names = ["lattigo_tpu_torch"]
    for info in pkgutil.walk_packages(lattigo_tpu_torch.__path__,
                                      "lattigo_tpu_torch."):
        names.append(info.name)
    return names


def test_port_imports_no_jax():
    mods = _modules()
    assert "lattigo_tpu_torch.interop" in mods
    assert "lattigo_tpu_torch.ring.ntt_mxu" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'lattigo_tpu' or m.startswith('lattigo_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_default_device_is_cuda_or_raises():
    from lattigo_tpu_torch.schemes import bgv
    lit = bgv.ParametersLiteral(log_n=10, log_q=(40, 40), log_p=(45,), t=65537)
    if torch.cuda.is_available():
        assert bgv.Parameters(lit).ring_q.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            bgv.Parameters(lit)
    assert bgv.Parameters(lit, device="cpu").ring_q.q.device.type == "cpu"
