"""Port parity: the native XOF of lattigo_tpu_torch (``csrc/xof.cpp``,
loaded by ``lattigo_tpu_torch.native``) against its plain version and
against ``lattigo_tpu.native``.

* ``KeyedPRNG.read_u64`` (native) against ``read_u64_plain`` (Python's
  hashlib), word for word and counter for counter, across reads that end
  inside a block;
* ``xof_fill_u64`` and ``xof_uniform_mod_q`` against the JAX package's
  native library and against Python big-int reduction;
* the BLAKE2b reference's keyed test vector (key 00..3f, the 8 input
  bytes 00..07, read as one counter word) and RFC 7693's "abc" digest
  through hashlib, the construction the plain version uses;
* ``uniform_poly`` equal from both streams;
* a build with no compiler raises ``RuntimeError``: there is no fallback.
"""

import hashlib

import numpy as np
import pytest

from lattigo_tpu import native as jnative
from lattigo_tpu_torch import build, native
from lattigo_tpu_torch.ring.ring import Ring
from lattigo_tpu_torch.ring.sampling import KeyedPRNG
from lattigo_tpu_torch.utils.primes import NTTFriendlyPrimesGenerator

KEYS = [b"", b"k", b"0123456789abcdef" * 4, bytes(range(80))]


@pytest.mark.parametrize("key", KEYS)
def test_read_u64_native_vs_plain(key):
    a, b = KeyedPRNG(key), KeyedPRNG(key)
    for count in (1, 7, 8, 9, 64, 1000, 3):
        got, want = a.read_u64(count), b.read_u64_plain(count)
        assert got.dtype == np.uint64 and got.shape == (count,)
        np.testing.assert_array_equal(got, want)
        assert a.counter == b.counter


@pytest.mark.parametrize("key", KEYS[:3])
@pytest.mark.parametrize("count", [1, 9, 1000])
def test_fill_vs_jax_native(key, count):
    assert jnative.load() is not None
    got, ctr = native.xof_fill_u64(key, 5, count)
    want, want_ctr = jnative.xof_fill_u64(key, 5, count)
    assert ctr == want_ctr
    np.testing.assert_array_equal(got, want)


def test_uniform_mod_q_vs_jax_native_and_big_ints():
    key, n = b"crs-seed", 256
    for q in ((1 << 45) - (1 << 14) + 1,
              NTTFriendlyPrimesGenerator(61, 1 << 13).next_downstream_prime()):
        got, ctr = native.xof_uniform_mod_q(key, 3, q, n)
        want, want_ctr = jnative.xof_uniform_mod_q(key, 3, q, n)
        assert ctr == want_ctr
        np.testing.assert_array_equal(got, want)
        hi, c1 = native.xof_fill_u64(key, 3, n)
        lo, c2 = native.xof_fill_u64(key, c1, n)
        assert c2 == ctr
        big = ((hi.astype(object) << 64) | lo.astype(object)) % q
        np.testing.assert_array_equal(got, big.astype(np.uint64))
    with pytest.raises(ValueError):
        native.xof_uniform_mod_q(key, 0, 97, 12)


def test_keyed_reference_vector():
    # blake2b-512, key 00..3f, input 00..07 (the BLAKE2 reference's keyed
    # test vector of that length): the stream block at that counter
    want = bytes.fromhex(
        "380beaf6ea7cc9365e270ef0e6f3a64fb902acae51dd5512f84259ad2c91f4bc"
        "4108db73192a5bbfb0cbcf71e46c3e21aee1c5e860dc96e8eb0b7b8426e6abe9")
    counter = int.from_bytes(bytes(range(8)), "little")
    got, nxt = native.xof_fill_u64(bytes(range(64)), counter, 8)
    assert got.astype("<u8").tobytes() == want and nxt == counter + 1
    assert hashlib.blake2b(bytes(range(8)), key=bytes(range(64))).digest() == want
    # RFC 7693 Appendix A: BLAKE2b-512("abc"), the hashlib the plain path uses
    assert hashlib.blake2b(b"abc").hexdigest().startswith("ba80a53f981c4d0d6a2797b6")
    with pytest.raises(ValueError):
        native.xof_fill_u64(bytes(65), 0, 8)


def test_uniform_poly_native_vs_plain():
    n = 1024
    moduli = NTTFriendlyPrimesGenerator(50, 2 * n).next_alternating_primes(3)
    ring = Ring(n, moduli, device="cpu")
    a, b = KeyedPRNG(b"mp-cpk"), KeyedPRNG(b"mp-cpk")
    b.read_u64 = b.read_u64_plain
    for level in (None, 1):
        got, want = a.uniform_poly(ring, level), b.uniform_poly(ring, level)
        assert got.equal(want) and a.counter == b.counter


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    native._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            KeyedPRNG(b"seed").read_u64(8)
        assert not any((tmp_path / "_build").iterdir())
    finally:
        native._lib.cache_clear()
