"""Port parity: lattigo_tpu_torch.ring.modops against lattigo_tpu.ring.modops.

The same integers (numpy, seeded) go through both packages; every result
is compared exactly (tolerance 0), lazy ones mod q. Operands include
64-bit patterns at or above 2^63, which torch holds as negative int64.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from lattigo_tpu.ring import modops as jm
from lattigo_tpu.utils.primes import NTTFriendlyPrimesGenerator
from lattigo_tpu_torch.interop import to_numpy, to_torch
from lattigo_tpu_torch.ring import modops as tm

BITS = [25, 28, 30, 40, 50, 60]
N = 2048


def _setup(bits):
    q = NTTFriendlyPrimesGenerator(bits, 2 * N).next_alternating_prime()
    bhi, blo = jm.gen_bred_constant(q)
    consts = dict(q=q, qinv=jm.gen_mred_constant(q), bhi=bhi, blo=blo)
    np_c = {k: np.array([[v]], dtype=np.uint64) for k, v in consts.items()}
    t_c = {k: to_torch(v, "cpu") for k, v in np_c.items()}
    rng = np.random.default_rng(bits)
    return q, np_c, t_c, rng


def _u64(rng, hi, size=(1, N)):
    """Uniform uint64 in [0, hi), hi <= 2^64."""
    return rng.integers(0, hi, size, dtype=np.uint64)


def _both(jfn, tfn, *args):
    got = to_numpy(tfn(*[to_torch(a, "cpu") for a in args]))
    want = np.asarray(jax.jit(jfn)(*[jnp.asarray(a) for a in args]))
    return got, want


@pytest.mark.parametrize("bits", BITS)
def test_mul_hi_and_barrett(bits):
    q, c, t, rng = _setup(bits)
    # full-width 64-bit operands, half of them >= 2^63
    a, b = _u64(rng, 1 << 64), _u64(rng, 1 << 64)
    assert (a >= np.uint64(1 << 63)).any()
    got, want = _both(jm.mul_hi, tm.mul_hi, a, b)
    np.testing.assert_array_equal(got, want)
    want_int = [(int(x) * int(y)) >> 64 for x, y in zip(a[0, :64], b[0, :64])]
    np.testing.assert_array_equal(got[0, :64], np.array(want_int, dtype=np.uint64))
    got, want = _both(lambda x: jm.bred_add(x, c["q"], c["bhi"]),
                      lambda x: tm.bred_add(x, t["q"], t["bhi"]), a)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, a % np.uint64(q))
    got, want = _both(lambda x: jm.bred_add_lazy(x, c["q"], c["bhi"]),
                      lambda x: tm.bred_add_lazy(x, t["q"], t["bhi"]), a)
    np.testing.assert_array_equal(got, want)
    x, y = _u64(rng, q), _u64(rng, q)
    got, want = _both(lambda u, v: jm.bred_mul(u, v, c["q"], c["bhi"], c["blo"]),
                      lambda u, v: tm.bred_mul(u, v, t["q"], t["bhi"], t["blo"]),
                      x, y)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", BITS)
def test_montgomery(bits):
    q, c, t, rng = _setup(bits)
    a = _u64(rng, 4 * q)          # lazy operand range of the callers
    b = _u64(rng, q)
    jq, jqi = c["q"], c["qinv"]
    tq, tqi = t["q"], t["qinv"]
    got, want = _both(lambda x, y: jm.mred(x, y, jq, jqi),
                      lambda x, y: tm.mred(x, y, tq, tqi), a, b)
    np.testing.assert_array_equal(got, want)
    exact = [int(x) * int(y) * pow(2, -64, q) % q for x, y in zip(a[0, :64], b[0, :64])]
    np.testing.assert_array_equal(got[0, :64], np.array(exact, dtype=np.uint64))
    # the caller-stated dispatch gives the same result as reading the table
    got_s = to_numpy(tm.mred(to_torch(a, "cpu"), to_torch(b, "cpu"), tq, tqi,
                             q < (1 << 30)))
    np.testing.assert_array_equal(got_s, want)
    got, want = _both(lambda x, y: jm.mred_lazy(x, y, jq, jqi),
                      lambda x, y: tm.mred_lazy(x, y, tq, tqi), a, b)
    np.testing.assert_array_equal(got, want)
    for jfn, tfn in [(jm.mul_mont, tm.mul_mont), (jm.mul_mont_lazy, tm.mul_mont_lazy),
                     (jm.mul_scalar_mont, tm.mul_scalar_mont)]:
        got, want = _both(lambda x, y: jfn(x, y, jq, jqi),
                          lambda x, y: tfn(x, y, tq, tqi), a, b)
        np.testing.assert_array_equal(got, want)
    # wide left operand: a·b < q·2^64 only
    wide = _u64(rng, 1 << 50)
    got, want = _both(lambda x, y: jm.mred_wide(x, y, jq, jqi),
                      lambda x, y: tm.mred_wide(x, y, tq, tqi), wide, b)
    np.testing.assert_array_equal(got, want)
    got, want = _both(lambda x: jm.mform(x, jq, c["bhi"], c["blo"]),
                      lambda x: tm.mform(x, tq, t["bhi"], t["blo"]), b)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :64], np.array(
        [(int(x) << 64) % q for x in b[0, :64]], dtype=np.uint64))
    got, want = _both(lambda x: jm.mform_lazy(x, jq, c["bhi"], c["blo"]),
                      lambda x: tm.mform_lazy(x, tq, t["bhi"], t["blo"]), b)
    np.testing.assert_array_equal(got, want)
    got, want = _both(lambda x: jm.imform(x, jq, jqi),
                      lambda x: tm.imform(x, tq, tqi), b)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", BITS)
def test_vector_ops(bits):
    q, c, t, rng = _setup(bits)
    a, b = _u64(rng, q), _u64(rng, q)
    a[0, :8] = 0
    for jfn, tfn in [
        (lambda x, y: jm.add_mod(x, y, c["q"]), lambda x, y: tm.add_mod(x, y, t["q"])),
        (lambda x, y: jm.sub_mod(x, y, c["q"]), lambda x, y: tm.sub_mod(x, y, t["q"])),
        (lambda x, y: jm.add_lazy(x, y), lambda x, y: tm.add_lazy(x, y)),
    ]:
        got, want = _both(jfn, tfn, a, b)
        np.testing.assert_array_equal(got, want)
    for jfn, tfn in [
        (lambda x: jm.neg_mod(x, c["q"]), lambda x: tm.neg_mod(x, t["q"])),
        (lambda x: jm.double_mod(x, c["q"]), lambda x: tm.double_mod(x, t["q"])),
        (lambda x: jm.cred(x + c["q"], c["q"]), lambda x: tm.cred(x + t["q"], t["q"])),
    ]:
        got, want = _both(jfn, tfn, a)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", BITS)
def test_lazy_tree_sum(bits):
    q, c, t, rng = _setup(bits)
    terms = _u64(rng, 2 * q, size=(9, 3, 256))
    jm_margin = max(1, ((1 << 64) - 1) // (2 * q) - 1)
    got = to_numpy(tm.lazy_tree_sum(to_torch(terms, "cpu"), t["q"], t["bhi"],
                                    tm.margin_for(q)))
    want = np.asarray(jm.lazy_tree_sum(jnp.asarray(terms), c["q"], c["bhi"],
                                       jm_margin))
    assert (got < np.uint64(2 * q)).all()
    np.testing.assert_array_equal(got % np.uint64(q), want % np.uint64(q))
    exact = np.array(terms.astype(object).sum(axis=0) % q, dtype=np.uint64)
    np.testing.assert_array_equal(got % np.uint64(q), exact)


@pytest.mark.parametrize("bits", [28, 60])
def test_mred_sum_chunks(bits, monkeypatch):
    """The chunked gadget MAC: at every chunk size the same values as one
    product over the whole digit axis (what a call under the limit runs),
    equal to the exact Σ_d a_d·b_d·2^-64 mod q."""
    q, c, t, rng = _setup(bits)
    beta, n = 7, 64
    a = _u64(rng, q, size=(2, beta, 1, 1, n))
    b = _u64(rng, q, size=(beta, 2, 1, n))
    ta, tb = to_torch(a, "cpu"), to_torch(b, "cpu")
    args = (t["q"], t["qinv"], t["bhi"], tm.margin_for(q))
    whole = tm.mred_sum(ta, tb, *args)
    assert whole.shape == (2, 2, 1, n)
    for digits in (1, 2, 3, 6):
        monkeypatch.setattr(tm, "MAC_CHUNK_BYTES", digits * 8 * 2 * 2 * n)
        np.testing.assert_array_equal(to_numpy(tm.mred_sum(ta, tb, *args)),
                                      to_numpy(whole))
    rinv = pow(1 << 64, -1, q)
    exact = (a.astype(object) * b.astype(object)).sum(axis=1) * rinv % q
    np.testing.assert_array_equal(to_numpy(whole), np.array(exact, dtype=np.uint64))
