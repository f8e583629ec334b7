"""Build and load the hand-written CUDA kernels and the native host code.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a``, each ``csrc/<name>.cpp`` (host code) by ``g++ -O3 -shared
-fPIC``, into ``_build/lib<name>-<hash>.so`` at first use (the hash is of
the source, so an edited source rebuilds), then loaded with ``ctypes``.
Each build writes a temporary file and renames it into place, so several
processes may build one source at once. Nothing is built when a module is
imported: the CPU paths of the kernels never need ``nvcc``; the native
host code needs ``g++`` on every device, and a failed build raises.
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


def _gxx() -> str:
    cand = shutil.which("g++")
    if cand is None:
        raise RuntimeError("g++ not found: the native host code cannot be built")
    return cand


def _source(name: str) -> Path:
    """``csrc/<name>.cu`` (a CUDA kernel) or ``csrc/<name>.cpp`` (host code)."""
    for suffix in (".cu", ".cpp"):
        src = CSRC_DIR / f"{name}{suffix}"
        if src.is_file():
            return src
    raise FileNotFoundError(f"no source csrc/{name}.cu or .cpp")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(_source(name).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile_cmd(name: str, out: Path) -> list[str]:
    src = _source(name)
    if src.suffix == ".cpp":
        return [_gxx(), "-O3", "-shared", "-fPIC", "-o", str(out), str(src)]
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(src)]


def build(names: list[str]) -> dict[str, str]:
    """Compile every named source that is not built yet, one compiler per
    source, all started together. Returns each compiler's output (for a
    kernel, its ``-Xptxas -v`` register and shared-memory report)."""
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = _compile_cmd(name, Path(tmp))
        except RuntimeError:                     # no compiler
            os.unlink(tmp)
            raise
        procs[name] = (tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
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
        raise RuntimeError("the build failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cpp``, built first if
    needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
