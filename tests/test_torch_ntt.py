"""Port parity: the NTT engines of lattigo_tpu_torch against lattigo_tpu.

* the radix-2 engine (ring/ntt.py) against lattigo_tpu.ring.ntt at
  28/40/60-bit primes, bit for bit (lazy outputs included: same algorithm);
* the four-step tables against lattigo_tpu.ring.ntt_mxu.gen_mxu_tables
  after an int8 cast;
* the four-step plain version against lattigo_tpu's NTTMxu with int8 digits
  in Pallas interpret mode, bit for bit, lazy [0, 2q) outputs included;
* the port's ring NTT against the JAX CPU ring, whose radix-2 lazy outputs
  are in [0, 4q): compared mod q.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lattigo_tpu.ring import ntt as jntt
from lattigo_tpu.ring import ntt_mxu as jmxu
from lattigo_tpu.ring.ring import Ring as JRing
from lattigo_tpu.utils.primes import NTTFriendlyPrimesGenerator
from lattigo_tpu_torch.interop import to_numpy, to_torch
from lattigo_tpu_torch.ring import ntt as tntt
from lattigo_tpu_torch.ring import ntt_mxu as tmxu
from lattigo_tpu_torch.ring.ring import Ring as TRing
from lattigo_tpu_torch.utils.primes import (
    NTTFriendlyPrimesGenerator as TGen, primitive_nth_root,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here, and
    they crowd the other test workers' cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moduli(bits, n, k):
    return NTTFriendlyPrimesGenerator(bits, 2 * n).next_alternating_primes(k)


def test_primes_match():
    for bits, n in [(28, 1 << 14), (40, 1 << 12), (60, 1 << 16), (20, 1 << 12)]:
        want = NTTFriendlyPrimesGenerator(bits, 2 * n).next_alternating_primes(6)
        assert TGen(bits, 2 * n).next_alternating_primes(6) == want
        ring = JRing(256, want[:1])
        assert primitive_nth_root(want[0], 512) == ring.subrings[0].psi


@pytest.mark.parametrize("bits", [28, 40, 60])
@pytest.mark.parametrize("lazy", [False, True])
def test_radix2_engine(bits, lazy):
    n = 1024
    moduli = _moduli(bits, n, 3)
    jr, tr = JRing(n, moduli), TRing(n, moduli, device="cpu")
    rng = np.random.default_rng(bits)
    x = (rng.integers(0, 1 << 62, (2, 3, n), dtype=np.uint64)
         % np.array(moduli, dtype=np.uint64)[:, None])
    got = to_numpy(tntt.ntt(to_torch(x, "cpu"), tr.roots, tr.q, tr.qinv,
                            tr.log_n, lazy=lazy))
    want = np.asarray(jax.jit(lambda v: jntt.ntt(
        v, jr.roots, jr.q, jr.qinv, jr.log_n, lazy=lazy))(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    canon = np.asarray(jax.jit(jr.ntt)(jnp.asarray(x)))
    got_i = to_numpy(tntt.intt(to_torch(canon, "cpu"), tr.iroots, tr.ninv,
                               tr.q, tr.qinv, tr.log_n, lazy=lazy))
    want_i = np.asarray(jax.jit(lambda v: jntt.intt(
        v, jr.iroots, jr.ninv, jr.q, jr.qinv, jr.log_n, lazy=lazy))(
            jnp.asarray(canon)))
    np.testing.assert_array_equal(got_i, want_i)
    if not lazy:
        np.testing.assert_array_equal(got_i, x)


def test_mxu_tables():
    n = 4096
    q = _moduli(28, n, 1)[0]
    psi = primitive_nth_root(q, 2 * n)
    eng = jmxu.NTTMxu(n, [q], [psi], dtype=jnp.int8)
    rr, cc = eng.rr, eng.cc
    want = jmxu.gen_mxu_tables(n, rr, cc, psi, q)
    got = tmxu.gen_mxu_tables(n, rr, cc, psi, q)
    for k in ("w1f", "w2f", "w1i", "w2i"):
        assert got[k].dtype == np.int8
        np.testing.assert_array_equal(got[k], want[k].astype(np.int8))
        np.testing.assert_array_equal(got[k].astype(np.float32), want[k])
    for k in ("tf", "ti"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(tmxu.gen_consts([q]), np.asarray(eng.consts))


@pytest.fixture(scope="module")
def mxu_pair():
    n = 4096
    moduli = _moduli(28, n, 2)
    jr = JRing(n, moduli)
    psis = [s.psi for s in jr.subrings]
    jeng = jmxu.NTTMxu(n, moduli, psis, dtype=jnp.int8)
    tr = TRing(n, moduli, device="cpu")
    assert tr.ntt_engine == "mxu-plain"
    rng = np.random.default_rng(0)
    x = rng.integers(0, min(moduli), (3, 2, n)).astype(np.uint64)
    return jr, jeng, tr, moduli, x


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_mxu_plain_vs_pallas(mxu_pair, inverse, lazy):
    jr, jeng, tr, moduli, x = mxu_pair
    fn = jeng.intt if inverse else jeng.ntt
    want = np.asarray(fn(jnp.asarray(x), 1, lazy=lazy, interpret=True))
    got = to_numpy(tmxu.four_step_plain(tr._mxu, to_torch(x, "cpu"), 0,
                                        inverse, lazy))
    np.testing.assert_array_equal(got, want)
    bound = 2 if lazy else 1
    for i, q in enumerate(moduli):
        assert got[:, i].max() < bound * q
    # the ring dispatches a CPU tensor to the plain version
    ring_fn = tr.intt if inverse else tr.ntt
    np.testing.assert_array_equal(
        to_numpy(ring_fn(to_torch(x, "cpu"), lazy=lazy)), got)
    # against the JAX CPU ring (radix-2, lazy in [0, 4q)): equal mod q
    jfn = jr.intt if inverse else jr.ntt
    ref = np.asarray(jax.jit(lambda v: jfn(v, lazy=lazy))(jnp.asarray(x)))
    qs = np.array(moduli, dtype=np.uint64)[:, None]
    np.testing.assert_array_equal(got % qs, ref % qs)


@pytest.mark.parametrize("inverse", [False, True])
def test_mxu_single_limb_offset(mxu_pair, inverse):
    jr, jeng, tr, moduli, x = mxu_pair
    x1 = x[:, 1:2, :]
    fn = jeng.intt_single if inverse else jeng.ntt_single
    want = np.asarray(fn(1, jnp.asarray(x1), interpret=True))
    tfn = tr.intt_single if inverse else tr.ntt_single
    got = to_numpy(tfn(1, to_torch(x1, "cpu")))
    np.testing.assert_array_equal(got, want)
    back = tr.ntt_single if inverse else tr.intt_single
    np.testing.assert_array_equal(to_numpy(back(1, to_torch(got, "cpu"))), x1)


@pytest.fixture(scope="module", params=[(15, 2), (16, 1)], ids=["logN15", "logN16"])
def wide_pair(request):
    """The four-step shapes of R = 256 (C = 128 at logN 15, 256 at logN
    16), where the kernel runs one launch a step: the JAX engine with int8
    digits and the port's plain version on 28-bit primes; inputs uniform
    with every third coefficient at q - 1."""
    logn, k = request.param
    n = 1 << logn
    moduli = _moduli(28, n, k)
    psis = [primitive_nth_root(q, 2 * n) for q in moduli]
    jeng = jmxu.NTTMxu(n, moduli, psis, dtype=jnp.int8)
    tr = TRing(n, moduli, device="cpu")
    assert tr.ntt_engine == "mxu-plain"
    assert (tr._mxu.rr, tr._mxu.cc) == (jeng.rr, jeng.cc) == (256, n // 256)
    qs = np.array(moduli, dtype=np.uint64)[:, None]
    x = np.random.default_rng(logn).integers(0, 1 << 62, (1, k, n), dtype=np.uint64) % qs
    x[..., ::3] = (qs - np.uint64(1))
    return jeng, tr, moduli, x


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_mxu_plain_vs_pallas_wide(wide_pair, inverse, lazy):
    jeng, tr, moduli, x = wide_pair
    fn = jeng.intt if inverse else jeng.ntt
    want = np.asarray(fn(jnp.asarray(x), len(moduli) - 1, lazy=lazy, interpret=True))
    got = to_numpy(tmxu.four_step_plain(tr._mxu, to_torch(x, "cpu"), 0,
                                        inverse, lazy))
    np.testing.assert_array_equal(got, want)
    bound = 2 if lazy else 1
    for i, q in enumerate(moduli):
        assert got[:, i].max() < bound * q


def test_mxu_roundtrip_and_offset_wide(wide_pair):
    jeng, tr, moduli, x = wide_pair
    xt = to_torch(x, "cpu")
    y = tr.ntt(xt)
    np.testing.assert_array_equal(to_numpy(tr.intt(y)), x)
    i = len(moduli) - 1
    yi = tr.ntt_single(i, xt[:, i:i + 1].contiguous())
    np.testing.assert_array_equal(to_numpy(yi), to_numpy(y[:, i:i + 1]))
