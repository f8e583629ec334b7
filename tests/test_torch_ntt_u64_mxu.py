"""Port parity: the u64 four-step engine of lattigo_tpu_torch against lattigo_tpu.

* ``ring/ntt_u64_mxu.py``'s ``NTTMxu64`` against
  ``lattigo_tpu.ring.ntt_u64_mxu.NTTMxu64``, both called directly on the CPU
  at logN 12 (the JAX side under one ``jax.jit`` per call), bit for bit
  (tolerance 0), lazy [0, 2q) outputs included: 40-, 45-, 53- and 61-bit
  chains, the mixed 25/51/61-bit chain (the recombination's wide
  Montgomery product on a small prime), forward and inverse, and
  ``ntt_single`` / ``intt_single`` at limb 1;
* inputs at the top of the port's contract, [0, 2q) with coefficients at
  2q - 1, at 45, 53 and 61 bits (the reference's plane count claims 4q and
  holds about 2q there);
* the host tables and digit planes against the JAX package's helpers;
* the reduced digit planes of narrower chains (6 at 44 bits, 7 at 51);
* the port's two contractions (int8 ``torch._int_mm``, float64 matmul)
  equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lattigo_tpu.ring import ntt_u64_mxu as jmxu64
from lattigo_tpu.utils.primes import NTTFriendlyPrimesGenerator
from lattigo_tpu_torch.interop import to_numpy, to_torch
from lattigo_tpu_torch.ring import ntt_u64_mxu as tmxu64
from lattigo_tpu_torch.ring.ntt_mxu import gen_four_step_weights
from lattigo_tpu_torch.ring.ring import Ring as TRing
from lattigo_tpu_torch.utils.primes import primitive_nth_root

N = 1 << 12
BATCH = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _primes(bits: int, k: int) -> list[int]:
    """k distinct NTT-friendly primes of ``bits`` bits below 2^bits."""
    gen = NTTFriendlyPrimesGenerator(bits, 2 * N)
    return [gen.next_downstream_prime() for _ in range(k)]


CHAINS = {
    "40": _primes(40, 3),
    "45": _primes(45, 2),
    "53": _primes(53, 2),
    "61": _primes(61, 2),
    "mixed 25/51/61": _primes(25, 1) + _primes(51, 1) + _primes(61, 1),
}


def _top_inputs(moduli, seed: int) -> np.ndarray:
    """uint64 [BATCH, L, N] uniform in [0, 2q), the first 8 coefficients of
    every limb 2q - 1: the top of the port's input contract."""
    rng = np.random.default_rng(seed)
    qs = np.array(moduli, dtype=np.uint64)[:, None]
    x = rng.integers(0, 1 << 62, (BATCH, len(moduli), N), dtype=np.uint64) % (2 * qs)
    x[..., :8] = 2 * qs - 1
    return x


@pytest.fixture(scope="module", params=list(CHAINS))
def pair(request):
    moduli = CHAINS[request.param]
    assert all(q < 1 << 61 for q in moduli)
    psis = [primitive_nth_root(q, 2 * N) for q in moduli]
    tr = TRing(N, moduli, device="cpu")
    assert tr.ntt_engine == "mxu64-plain"
    return dict(name=request.param, moduli=moduli, jeng=jmxu64.NTTMxu64(N, moduli, psis),
                teng=tr._kernel, ring=tr, x=_top_inputs(moduli, len(request.param)))


def _jax_apply(jeng, x, inverse: bool, lazy: bool, limb: int | None = None):
    if limb is None:
        fn = jeng.intt if inverse else jeng.ntt
        return np.asarray(jax.jit(lambda v: fn(v, v.shape[-2] - 1, lazy=lazy))(
            jnp.asarray(x)))
    fn = jeng.intt_single if inverse else jeng.ntt_single
    return np.asarray(jax.jit(lambda v: fn(limb, v, lazy=lazy))(jnp.asarray(x)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_engine_vs_jax(pair, inverse, lazy):
    x, moduli = pair["x"], pair["moduli"]
    want = _jax_apply(pair["jeng"], x, inverse, lazy)
    fn = pair["teng"].intt if inverse else pair["teng"].ntt
    got = to_numpy(fn(to_torch(x, "cpu"), lazy=lazy))
    np.testing.assert_array_equal(got, want)
    qs = np.array(moduli, dtype=np.uint64)[:, None]
    assert (got < (2 if lazy else 1) * qs).all()
    # the ring dispatches to the engine
    ring_fn = pair["ring"].intt if inverse else pair["ring"].ntt
    np.testing.assert_array_equal(to_numpy(ring_fn(to_torch(x, "cpu"), lazy=lazy)), got)


@pytest.mark.parametrize("inverse", [False, True])
def test_single_limb_vs_jax(pair, inverse):
    x1 = np.ascontiguousarray(pair["x"][:, 1:2, :])
    want = _jax_apply(pair["jeng"], x1, inverse, False, limb=1)
    ring = pair["ring"]
    fn = ring.intt_single if inverse else ring.ntt_single
    got = to_numpy(fn(1, to_torch(x1, "cpu")))
    np.testing.assert_array_equal(got, want)
    back = ring.ntt_single if inverse else ring.intt_single
    q1 = np.uint64(pair["moduli"][1])
    np.testing.assert_array_equal(to_numpy(back(1, to_torch(got, "cpu"))), x1 % q1)


def test_contractions_equal(pair):
    xt = to_torch(pair["x"], "cpu")
    eng, sl = pair["teng"], slice(0, len(pair["moduli"]))
    for inverse in (False, True):
        for lazy in (False, True):
            a = eng._apply(xt, sl, inverse, lazy, "int8")
            b = eng._apply(xt, sl, inverse, lazy, "f64")
            assert torch.equal(a, b)


def test_plane_counts_hold_the_contract(pair):
    eng, qmax = pair["teng"], max(pair["moduli"])
    assert tmxu64.max_balanced(eng.nd_in) >= 2 * qmax - 1
    assert tmxu64.max_balanced(eng.nd_in - 1) < 2 * qmax - 1
    assert tmxu64.max_balanced(eng.nd_out) >= qmax - 1
    assert eng.nd_in == pair["jeng"].nd_in and eng.nd_out == pair["jeng"].nd_out


@pytest.mark.parametrize("bits, nd", [(44, 6), (51, 7)])
def test_reduced_digit_planes(bits, nd):
    moduli = _primes(bits, 2)
    tr = TRing(N, moduli, device="cpu")
    eng = tr._kernel
    assert (eng.nd_in, eng.nd_out) == (nd, nd)
    psis = [s.psi for s in tr.subrings]
    jeng = jmxu64.NTTMxu64(N, moduli, psis)
    assert (jeng.nd_in, jeng.nd_out) == (nd, nd)
    x = _top_inputs(moduli, bits)
    np.testing.assert_array_equal(to_numpy(tr.ntt(to_torch(x, "cpu"))),
                                  _jax_apply(jeng, x, False, False))


@pytest.mark.parametrize("contract_first", [False, True])
def test_extend_weight_vs_jax(contract_first):
    q = CHAINS["53"][0]
    psi = primitive_nth_root(q, 2 * N)
    raw = gen_four_step_weights(N, 32, 128, psi, q)
    for key in ("wa", "wb"):
        want = jmxu64._extend_weight8(raw[key], q, contract_first, 7, 7)
        got = tmxu64._extend_weight8(raw[key], q, contract_first, 7, 7)
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want)


def test_digits_vs_jax():
    q = CHAINS["61"][0]
    x = np.random.default_rng(3).integers(0, 2 * q, (2, 1, 32, 128), dtype=np.uint64)
    x[0, 0, 0, :4] = 2 * q - 1
    want = np.asarray(jmxu64._digits8(jnp.asarray(x), axis=-2, nd=8))
    # the port's planes: x's dims + a digit axis, here moved before R
    got = tmxu64._digits8(to_torch(x, "cpu"), (0, 1, 4, 2, 3), 8).numpy()
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_contract_bounds():
    with pytest.raises(ValueError):
        tmxu64.NTTMxu64(N, [(1 << 61) + 1], [3], "cpu")
    with pytest.raises(ValueError):
        tmxu64.NTTMxu64(2048, CHAINS["40"], [3] * 3, "cpu")
    with pytest.raises(ValueError):
        tmxu64.digit_count(1 << 63)


def test_chunked_batch_equal(pair, monkeypatch):
    """A batch above CHUNK coefficients goes in chunks of whole
    polynomials, with the same result."""
    xt = to_torch(pair["x"], "cpu")
    ring = pair["ring"]
    want = (ring.ntt(xt), ring.intt(xt, lazy=True))
    monkeypatch.setattr(tmxu64, "CHUNK", N * len(pair["moduli"]))
    got = (ring.ntt(xt), ring.intt(xt, lazy=True))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
