"""The port stands alone: no module of lattigo_tpu_torch, and none of
chip_smoke.py, the kernel benches and interop.py, imports JAX or the JAX
package; and an entry point given no device runs on CUDA or raises, never
silently on the CPU."""

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
    assert "lattigo_tpu_torch.schemes.ckks" in mods
    assert "lattigo_tpu_torch.circuits.lintrans" in mods
    for m in ("polynomial", "mod1", "dft", "bootstrapping",
              "bootstrapping_presets", "bgv_polynomial", "minimax",
              "comparison", "inverse"):
        assert "lattigo_tpu_torch.circuits." + m in mods
    for m in ("ring.ntt_ci", "rlwe.ring_packing", "schemes.ckks.bridge",
              "ring.ntt_u64_mxu", "native"):
        assert "lattigo_tpu_torch." + m in mods
    assert "lattigo_tpu_torch.utils.cosine" in mods
    assert "lattigo_tpu_torch.utils.minimax" in mods
    assert "lattigo_tpu_torch.utils.ddarith" in mods
    for m in ("lattigo_wire", "serialization", "noise"):
        assert "lattigo_tpu_torch.utils." + m in mods
    for m in ("", ".protocols", ".threshold", ".additive_shares", ".sharing",
              ".sharing_bgv"):
        assert "lattigo_tpu_torch.multiparty" + m in mods
    for m in ("", ".mesh", ".ntt_sp", ".spmd", ".launch", ".dryrun"):
        assert "lattigo_tpu_torch.parallel" + m in mods
    examples = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    assert len(examples) == 16
    for m in examples:
        assert "lattigo_tpu_torch.examples." + m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke', 'bench_ntt_u32', 'bench_ntt_mxu']:\n"
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


def test_ckks_default_device_is_cuda_or_raises():
    from lattigo_tpu_torch.presets import ckks_tpu_params
    from lattigo_tpu_torch.schemes import ckks
    lit = ckks.ParametersLiteral(log_n=10, log_q=(40, 40), log_p=(45,))
    if torch.cuda.is_available():
        params = ckks.Parameters(lit)
        assert params.ring_q.device.type == "cuda"
        assert params.ring_p.q.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ckks.Parameters(lit)
        with pytest.raises(RuntimeError, match="CUDA"):
            ckks.Parameters(ckks_tpu_params(12, 218))
    assert ckks.Parameters(lit, device="cpu").ring_q.q.device.type == "cpu"


def test_spawned_rank_imports_no_jax():
    """A rank spawned by parallel.launch re-imports only the package."""
    from lattigo_tpu_torch.parallel import launch
    infos = launch.run(launch.world_info, 2, "cpu")
    assert [i["rank"] for i in infos] == [0, 1]
    for info in infos:
        assert info["world"] == 2 and info["backend"] == "gloo"
        bad = [m for m in info["modules"] if m == "jax" or m.startswith("jax.")
               or m == "lattigo_tpu" or m.startswith("lattigo_tpu.")]
        assert not bad, bad


def test_launch_target_must_be_in_the_port():
    from lattigo_tpu_torch.parallel import launch
    with pytest.raises(ValueError, match="lattigo_tpu_torch"):
        launch.run(test_launch_target_must_be_in_the_port, 2, "cpu")


def test_make_mesh_without_device_needs_cuda():
    from lattigo_tpu_torch.parallel import make_mesh
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: make_mesh() would take it")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
