"""The native host XOF: BLAKE2b in keyed counter mode, in C++.

Counterpart of :mod:`lattigo_tpu.native` (its loader) with the port's own
copy of its source, ``csrc/xof.cpp``. The library is built by ``g++`` into
``_build/`` at first use (:mod:`lattigo_tpu_torch.build`) and loaded with
``ctypes``; a failed build or load raises. It backs
:class:`lattigo_tpu_torch.ring.sampling.KeyedPRNG`, whose hashlib loop
(``read_u64_plain``) is the plain version it is held against.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from lattigo_tpu_torch import build

_U64P = ctypes.POINTER(ctypes.c_uint64)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("xof")
    lib.xof_fill_u64.restype = ctypes.c_uint64
    lib.xof_fill_u64.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64,
                                 _U64P, ctypes.c_uint64]
    lib.xof_uniform_mod_q.restype = ctypes.c_uint64
    lib.xof_uniform_mod_q.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_uint64, ctypes.c_uint64, _U64P,
                                      ctypes.c_uint64]
    return lib


def _key(key: bytes) -> bytes:
    key = bytes(key)
    if len(key) > 64:
        raise ValueError("a BLAKE2b key has at most 64 bytes")
    return key


def xof_fill_u64(key: bytes, counter: int, count: int) -> tuple[np.ndarray, int]:
    """``count`` stream words from block ``counter``: (uint64[count], the
    next block counter). A read takes whole 8-word blocks."""
    key = _key(key)
    out = np.empty(count, dtype=np.uint64)
    nxt = _lib().xof_fill_u64(key, len(key), counter,
                              out.ctypes.data_as(_U64P), count)
    return out, int(nxt)


def xof_uniform_mod_q(key: bytes, counter: int, q: int, n: int) -> tuple[np.ndarray, int]:
    """n residues (hi·2^64 + lo) mod q from the stream's next 2n words (n
    words hi, then n words lo): (uint64[n], the next block counter).
    Needs 8 | n."""
    if n % 8:
        raise ValueError(f"n = {n} is not a multiple of 8")
    key = _key(key)
    out = np.empty(n, dtype=np.uint64)
    nxt = _lib().xof_uniform_mod_q(key, len(key), counter, q,
                                   out.ctypes.data_as(_U64P), n)
    return out, int(nxt)
