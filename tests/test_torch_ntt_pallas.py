"""Port parity: the u32 NTT engine of lattigo_tpu_torch against lattigo_tpu.

* the plain u32 engine (ring/ntt_pallas.py) against lattigo_tpu's NTTPallas
  in Pallas interpret mode at logN 9 and 10 on two alternating 29-bit
  primes, forward and inverse, lazy and not, full chain and at limb 1, bit
  for bit (the lazy [0, 4q) / [0, 2q) outputs are the same integers);
* the input range of both packages' u32 engines: the forward takes
  [0, 4q), the inverse [0, 2q);
* the compact u32 root tables against the JAX package's [logN, N] stage
  tables, which they collapse to;
* the engine each (N, prime size) takes, by the rule of
  lattigo_tpu/ring/ring.py:_build_pallas (which returns None off a TPU, so
  the rule is written out here), its third branch (the u64 four-step
  engine for q < 2^61, N ≥ 4096) included.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lattigo_tpu.ring import ntt_pallas as jpal
from lattigo_tpu.ring.ntt import bit_reverse
from lattigo_tpu.utils.primes import NTTFriendlyPrimesGenerator
from lattigo_tpu_torch.interop import to_numpy, to_torch
from lattigo_tpu_torch.ring import ntt_pallas as tpal
from lattigo_tpu_torch.ring.ring import Ring as TRing


def _moduli(bits, n, k):
    return NTTFriendlyPrimesGenerator(bits, 2 * n).next_alternating_primes(k)


@pytest.fixture(scope="module", params=[9, 10])
def pair(request):
    n = 1 << request.param
    moduli = _moduli(29, n, 2)
    assert max(moduli) >= 1 << 29          # off the four-step engine's range
    tr = TRing(n, moduli, device="cpu")
    assert tr.ntt_engine == "u32-plain"
    jeng = jpal.NTTPallas(n, moduli, [s.psi for s in tr.subrings])
    rng = np.random.default_rng(request.param)
    x = (rng.integers(0, 1 << 62, (3, 2, n), dtype=np.uint64)
         % np.array(moduli, dtype=np.uint64)[:, None])
    return tr, jeng, moduli, x


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_u32_plain_vs_pallas(pair, inverse, lazy):
    tr, jeng, moduli, x = pair
    if inverse:                   # the inverse takes the forward's lazy range
        x = np.asarray(jeng.ntt(jnp.asarray(x), 1, lazy=True, interpret=True))
    fn = jeng.intt if inverse else jeng.ntt
    want = np.asarray(fn(jnp.asarray(x), 1, lazy=lazy, interpret=True))
    got = to_numpy(tpal.u32_plain(tr._u32, to_torch(x, "cpu"), 0, inverse, lazy))
    np.testing.assert_array_equal(got, want)
    bound = (2 if inverse else 4) if lazy else 1
    for i, q in enumerate(moduli):
        assert got[:, i].max() < bound * q
    # the ring sends a CPU tensor to the plain version
    ring_fn = tr.intt if inverse else tr.ntt
    np.testing.assert_array_equal(
        to_numpy(ring_fn(to_torch(x, "cpu"), lazy=lazy)), got)


@pytest.mark.parametrize("inverse", [False, True])
def test_u32_single_limb_offset(pair, inverse):
    tr, jeng, moduli, x = pair
    x1 = x[:, 1:2, :]
    fn = jeng.intt_single if inverse else jeng.ntt_single
    tfn = tr.intt_single if inverse else tr.ntt_single
    for lazy in (False, True):
        want = np.asarray(fn(1, jnp.asarray(x1), lazy=lazy, interpret=True))
        got = to_numpy(tfn(1, to_torch(x1, "cpu"), lazy=lazy))
        np.testing.assert_array_equal(got, want)
    back = tr.ntt_single if inverse else tr.intt_single
    np.testing.assert_array_equal(
        to_numpy(back(1, tfn(1, to_torch(x1, "cpu")))), x1)


@pytest.mark.parametrize("inverse, k", [(True, 0), (True, 1), (False, 0),
                                        (False, 1), (False, 2), (False, 3)])
def test_u32_input_contract(pair, inverse, k):
    """The input range both packages take: [0, 2q) for the inverse (of
    y + k q, y the forward of x, it returns x) and [0, 4q) for the forward
    (of x + k q it returns the forward of x)."""
    tr, jeng, moduli, x = pair
    kq = k * np.array(moduli, dtype=np.uint64)[:, None]
    y = np.asarray(jeng.ntt(jnp.asarray(x), 1, interpret=True))
    xin, want = (y + kq, x) if inverse else (x + kq, y)
    fn = jeng.intt if inverse else jeng.ntt
    np.testing.assert_array_equal(
        np.asarray(fn(jnp.asarray(xin), 1, interpret=True)), want)
    got = tpal.u32_plain(tr._u32, to_torch(xin, "cpu"), 0, inverse, False)
    np.testing.assert_array_equal(to_numpy(got), want)


def _stage_tables(compact: np.ndarray, inverse: bool) -> np.ndarray:
    """Spread a compact root table over the [logN, N] stage layout of
    lattigo_tpu.ring.ntt_pallas.gen_stage_roots."""
    n = compact.shape[-1]
    logn = n.bit_length() - 1
    ms = [1 << s for s in range(logn)]
    out = np.zeros((logn, n), dtype=np.uint32)
    for si, m in enumerate(ms[::-1] if inverse else ms):
        t = n // (2 * m)
        for g in range(m):
            out[si, g * 2 * t + t: (g + 1) * 2 * t] = compact[m + g]
    return out


def test_u32_tables(pair):
    tr, jeng, moduli, _ = pair
    eng = tr._u32
    consts = eng.consts.numpy().view(np.uint32)
    np.testing.assert_array_equal(consts[:, 0:1], np.asarray(jeng.q32))
    np.testing.assert_array_equal(consts[:, 1:2], np.asarray(jeng.qinv32))
    np.testing.assert_array_equal(consts[:, 2:3], np.asarray(jeng.ninv32))
    roots = eng.roots.numpy().view(np.uint32)
    iroots = eng.iroots.numpy().view(np.uint32)
    for i in range(len(moduli)):
        np.testing.assert_array_equal(_stage_tables(roots[i], False),
                                      np.asarray(jeng.wfwd[i]))
        np.testing.assert_array_equal(_stage_tables(iroots[i], True),
                                      np.asarray(jeng.winv[i]))
    # entry k of the compact table is MForm32(psi^brev(k))
    q, psi, logn = moduli[0], tr.subrings[0].psi, tr.log_n
    for k in (1, 2, 3, tr.n - 1):
        assert int(roots[0, k]) == (pow(psi, bit_reverse(k, logn), q) << 32) % q


def _jax_rule(n, moduli):
    """lattigo_tpu/ring/ring.py:325-363 on a TPU, STANDARD ring, no
    environment switches."""
    if n < 512:
        return "radix2"
    if n >= 4096 and all(q < (1 << 29) for q in moduli):
        return "mxu"
    if all(q < (1 << 30) for q in moduli) and n <= (1 << 15):
        return "u32"
    if n >= 4096 and all(q < (1 << 61) for q in moduli):
        return "mxu64"
    return "radix2"


@pytest.mark.parametrize("n, bits, k, engine", [
    (512, 28, 1, "u32"), (1024, 29, 1, "u32"), (4096, 28, 2, "mxu"),
    (4096, 29, 4, "u32"), (256, 28, 1, "radix2"), (1024, 31, 1, "radix2"),
    (4096, 40, 3, "mxu64"), (2048, 40, 3, "radix2"), (8192, 60, 2, "mxu64"),
    (4096, 31, 2, "mxu64"), (32768, 28, 2, "mxu"), (65536, 28, 2, "mxu"),
    (32768, 29, 2, "u32"), (32768, 30, 2, "mxu64"), (65536, 30, 2, "mxu64"),
])
def test_engine_choice(n, bits, k, engine):
    moduli = _moduli(bits, n, k)
    assert _jax_rule(n, moduli) == engine
    assert TRing(n, moduli, device="cpu").ntt_engine == engine + "-plain"
