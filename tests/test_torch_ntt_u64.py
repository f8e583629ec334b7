"""The u64 NTT kernel's plain version and the rings that take the kernel.

* ``ring/ntt_u64.py``'s :func:`u64_plain` (the function of
  ``csrc/ntt_u64.cu``) against the u64 four-step engine ``NTTMxu64`` on the
  CPU at N = 2^15, 2 limbs of a mixed 25 / 61-bit chain, inputs up to
  2q - 1: non-lazy outputs bit-equal, lazy ones equal mod q and in [0, 2q);
  ``*_single`` at limb 1;
* the ring's engine as a pure function of (device type, N, moduli): the
  kernel takes the ``mxu64`` rings on the card at N = 2^15 and 2^16, and
  every CPU ring keeps ``mxu64-plain`` (the kernel itself runs only on the
  card: ``tests/test_torch_kernels.py``).
"""

import pytest
import torch

from lattigo_tpu_torch.ring import ntt_u64
from lattigo_tpu_torch.ring.ring import CONJUGATE_INVARIANT, Ring, engine_name
from lattigo_tpu_torch.utils.primes import NTTFriendlyPrimesGenerator

N = 1 << 15


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _primes(n: int, bits) -> list[int]:
    """The next NTT-friendly prime below 2^b at 2n for each b in ``bits``."""
    gens = {b: NTTFriendlyPrimesGenerator(b, 2 * n) for b in set(bits)}
    return [gens[b].next_downstream_prime() for b in bits]


@pytest.fixture(scope="module")
def ring():
    r = Ring(N, _primes(N, (25, 61)), device="cpu")
    assert r.ntt_engine == "mxu64-plain" and r._u64 is None
    return r


@pytest.fixture(scope="module")
def x(ring):
    g = torch.Generator().manual_seed(15)
    q2 = 2 * ring.q
    out = torch.randint(0, 1 << 62, (2, 2, N), generator=g) % q2
    out[..., :8] = q2 - 1
    return out


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_plain_matches_mxu64(ring, x, inverse, lazy):
    eng = ntt_u64.NTTU64(N, ring.q, ring.qinv, ring.ninv, ring.roots, ring.iroots)
    got = ntt_u64.u64_plain(eng, x, 0, inverse, lazy)
    want = (ring.intt if inverse else ring.ntt)(x, lazy=lazy)
    q = ring.q
    if lazy:
        assert torch.equal(got % q, want % q)
        assert bool(((got >= 0) & (got < 2 * q)).all())
    else:
        assert torch.equal(got, want)
    one = x[:, 1:2].contiguous()
    single = ntt_u64.u64_plain(eng, one, 1, inverse, lazy)
    assert torch.equal(single, got[:, 1:2])


def test_engine_choice():
    for n in ntt_u64.SIZES:
        wide = _primes(n, (45, 55, 56))
        mixed = _primes(n, (25, 50, 61))
        for moduli in (wide, mixed):
            assert engine_name(n, moduli, "cuda") == "u64-cuda"
            assert engine_name(n, moduli, "cpu") == "mxu64-plain"
        assert engine_name(n, _primes(n, (28, 28)), "cuda") == "mxu-cuda"
        above = NTTFriendlyPrimesGenerator(61, 2 * n).next_upstream_prime()   # > 2^61
        assert engine_name(n, wide + [above], "cuda") == "radix2-plain"
        assert engine_name(n, wide, "cuda", CONJUGATE_INVARIANT) == "ci-plain"
    small_n = 1 << 14
    assert engine_name(small_n, _primes(small_n, (45, 55)), "cuda") == "mxu64-plain"
