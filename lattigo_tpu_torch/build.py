"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` at first use (the hash
is of the source, so an edited source rebuilds), then loaded with
``ctypes``. Nothing is built when a module is imported: the CPU paths
never need a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile_cmd(name: str, out: Path) -> list[str]:
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(CSRC_DIR / f"{name}.cu")]


def build(names: list[str]) -> dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together. Returns each compiler's output (its
    ``-Xptxas -v`` register and shared-memory report)."""
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (tmp, out, subprocess.Popen(
            _compile_cmd(name, Path(tmp)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = {}
    failed = []
    for name, (tmp, out, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
