"""Port parity for the KeyedPRNG and the RLWE pieces built on it.

``lattigo_tpu_torch.ring.sampling.KeyedPRNG`` against the JAX package's
(the word stream and ``uniform_poly`` for several seeds, levels and
chains, bit-identical), then seeded sk encryption, seeded gadget
encryption with ``compress_gadget`` / ``CompressedGadgetCiphertext.expand``,
``gen_public_key``, pk encryption (batched and not), ``gen_evaluation_key``,
``Ring.zero`` and the QP scalar product. The random parts are patched on
both sides to read the same numpy draws, in call order; everything that
derives from a seed is bit-equal as it stands (tolerance 0). The port's
own keys decrypt its results exactly (BGV slots against numpy).
"""

from contextlib import contextmanager

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lattigo_tpu import rlwe as jrlwe
from lattigo_tpu.multiparty import sharing as jsh, sharing_bgv as jshb
from lattigo_tpu.ring import sampling as jsampling
from lattigo_tpu.ring.ring import Ring as JRing
from lattigo_tpu.rlwe import keys as jkeys
from lattigo_tpu.schemes import bgv as jbgv
from lattigo_tpu_torch import interop, rlwe as trlwe
from lattigo_tpu_torch.multiparty import sharing as tsh, sharing_bgv as tshb
from lattigo_tpu_torch.ring import sampling as tsampling
from lattigo_tpu_torch.ring.ring import Ring as TRing, u64_tensor
from lattigo_tpu_torch.rlwe import keys as tkeys
from lattigo_tpu_torch.schemes import bgv as tbgv
from lattigo_tpu_torch.utils.primes import NTTFriendlyPrimesGenerator


# -- shared draws ---------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here, and
    they crowd the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Draws:
    """The i-th sampler call on one side gets the i-th numpy draw."""

    def __init__(self, seed: int):
        self.seed, self.i = seed, 0

    def rng(self):
        self.i += 1
        return np.random.default_rng([self.seed, self.i])

    def signed(self, n, dist, batch=()):
        r = self.rng()
        if getattr(dist, "sigma", None) is None:                    # ternary
            return r.integers(-1, 2, tuple(batch) + (n,))
        g = np.round(r.normal(0.0, dist.sigma, tuple(batch) + (n,)))
        return np.clip(g, -dist.bound, dist.bound).astype(np.int64)

    def uniform(self, moduli, n, batch=()):
        r = self.rng()
        return np.stack([r.integers(0, q, tuple(batch) + (n,), dtype=np.uint64)
                         for q in moduli], axis=-2)

    def ints(self, lo, hi, shape):
        return self.rng().integers(lo, hi, shape, dtype=np.int64)


@contextmanager
def shared_draws(seed: int):
    """Patch the samplers of both packages to read the same draws."""
    dj, dt = Draws(seed), Draws(seed)
    mp = pytest.MonkeyPatch()

    def lvl(ring, level):
        return ring.moduli[: (len(ring.moduli) - 1 if level is None else level) + 1]

    mp.setattr(jsampling, "signed", lambda key, n, dist, batch=():
               jnp.asarray(dj.signed(n, dist, batch)))
    mp.setattr(jsampling, "gaussian_signed",
               lambda key, n, dist=jsampling.DEFAULT_XE, batch=():
               jnp.asarray(dj.signed(n, dist, batch)))
    mp.setattr(jsampling, "uniform", lambda key, ring, level=None, batch=():
               jnp.asarray(dj.uniform(lvl(ring, level), ring.n, batch)))
    mp.setattr(jshb, "_sample_mask_t", lambda key, params: jnp.asarray(
        dj.ints(0, params.t, (1, params.n)).astype(np.uint64)))
    mp.setattr(jsh, "_sample_mask_signed", lambda key, n, b: jnp.asarray(
        dj.ints(-(1 << b), 1 << b, (n,))))
    mp.setattr(tsampling, "signed", lambda gen, n, dist, batch=():
               torch.from_numpy(dt.signed(n, dist, batch)))
    mp.setattr(tsampling, "gaussian_signed",
               lambda gen, n, dist=tsampling.DEFAULT_XE, batch=():
               torch.from_numpy(dt.signed(n, dist, batch)))
    mp.setattr(tsampling, "uniform", lambda gen, ring, level=None, batch=():
               u64_tensor(dt.uniform(lvl(ring, level), ring.n, batch), ring.device))
    mp.setattr(tshb, "_sample_mask_t", lambda gen, params, batch=(): torch.from_numpy(
        dt.ints(0, params.t, tuple(batch) + (1, params.n))))
    mp.setattr(tsh, "_sample_mask_signed", lambda gen, n, b, batch=(): torch.from_numpy(
        dt.ints(-(1 << b), 1 << b, tuple(batch) + (n,))))
    try:
        yield
    finally:
        mp.undo()


def _np(x):
    return interop.to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(j, t):
    np.testing.assert_array_equal(_np(t), np.asarray(j))


def assert_qp(j, t):
    assert_same(j.q, t.q)
    assert (j.p is None) == (t.p is None)
    if j.p is not None:
        assert_same(j.p, t.p)


KEY = jax.random.PRNGKey(0)
GEN = torch.Generator().manual_seed(0)
SEEDS = [b"", b"crs", bytes(range(100))]      # the last is cut to 64 bytes


@pytest.mark.parametrize("seed", SEEDS)
def test_stream(seed):
    a, b = jsampling.KeyedPRNG(seed), tsampling.KeyedPRNG(seed)
    for count in (0, 1, 8, 9, 17, 1000):
        np.testing.assert_array_equal(a.read_u64(count), b.read_u64(count))
        assert a.counter == b.counter


@pytest.mark.parametrize("bits, logn", [(28, 11), (45, 10), (61, 9)])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_poly(bits, logn, seed):
    """Levels None, 0 and 1 in one stream (the counter carries across
    limbs and polynomials), then a read after them."""
    n = 1 << logn
    moduli = NTTFriendlyPrimesGenerator(bits, 2 * n).next_alternating_primes(3)
    jr, tr = JRing(n, moduli), TRing(n, moduli, device="cpu")
    a, b = jsampling.KeyedPRNG(seed), tsampling.KeyedPRNG(seed)
    for level in (None, 0, 1):
        got = b.uniform_poly(tr, level)
        assert got.dtype == torch.int64 and got.shape == (
            (3 if level is None else level + 1), n)
        assert_same(a.uniform_poly(jr, level), got)
        assert bool((got >= 0).all() and (got < tr.q[: got.shape[0]]).all())
    np.testing.assert_array_equal(a.read_u64(5), b.read_u64(5))


CHAINS = {
    "28bit": dict(log_n=11, log_q=(28,) * 4, log_p=(28, 28), t=65537),
    "jax-tests": dict(log_n=10, log_q=(45, 35, 35), log_p=(50,), t=65537),
}


@pytest.fixture(scope="module", params=list(CHAINS))
def ctx(request):
    lit = CHAINS[request.param]
    pj = jbgv.Parameters(jbgv.ParametersLiteral(**lit))
    pt = tbgv.Parameters(tbgv.ParametersLiteral(**lit), device="cpu")
    rng = np.random.default_rng(1)
    coeffs = [rng.integers(-1, 2, pt.n) for _ in range(2)]
    kj, kt = jrlwe.KeyGenerator(pj), trlwe.KeyGenerator(pt)
    enc = tbgv.Encoder(pt)
    m = rng.integers(0, pt.t, (2, pt.n))
    return dict(pj=pj, pt=pt, kj=kj, kt=kt, enc=enc, m=m,
                sj=[kj.secret_key_from_signed(jnp.asarray(c)) for c in coeffs],
                st=[kt.secret_key_from_signed(torch.from_numpy(c)) for c in coeffs])


def test_ring_zero_and_qp_scalar(ctx):
    pj, pt = ctx["pj"], ctx["pt"]
    assert_same(pj.ring_q.zero(1, (2,)), pt.ring_q.zero(1, (2,)))
    assert pt.ring_q.zero(1, (2,)).shape == (2, 2, pt.n)
    assert_qp(pj.ring_qp.zero(0), pt.ring_qp.zero(0))
    sj, st = ctx["sj"][0].value, ctx["st"][0].value
    for k in (0, 1, 7, -3, (1 << 70) + 5):
        prod = pt.ring_qp.mul_scalar(st, k)
        assert_same(pj.ring_q.mul_scalar(sj.q, k), prod.q)
        assert_same(pj.ring_p.mul_scalar(sj.p, k), prod.p)


def test_seeded_encryption(ctx):
    pj, pt = ctx["pj"], ctx["pt"]
    for level in (None, 1):
        with shared_draws(2):
            cj = jax.jit(lambda: jrlwe.Encryptor(pj, ctx["sj"][0]).encrypt_zero_seeded(
                KEY, b"ct-seed", level).value)()
            ct = trlwe.Encryptor(pt, ctx["st"][0]).encrypt_zero_seeded(GEN, b"ct-seed", level)
        assert_same(cj, ct.value)
        assert_same(ct.value[1], tsampling.KeyedPRNG(b"ct-seed").uniform_poly(pt.ring_q, level))
    # the port's own draws: an encryption of zero decrypts to zero
    z = trlwe.Encryptor(pt, ctx["st"][0]).encrypt_zero_seeded(GEN, b"s")
    dec = trlwe.Decryptor(pt, ctx["st"][0]).decrypt(z)
    np.testing.assert_array_equal(ctx["enc"].decode(dec.replace(scale=1)), 0)
    with pytest.raises(TypeError):
        trlwe.Encryptor(pt, trlwe.KeyGenerator(pt).gen_public_key(GEN, ctx["st"][0])
                        ).encrypt_zero_seeded(GEN, b"s")


@pytest.mark.parametrize("level_q", [None, 1])
def test_compressed_gadget(ctx, level_q):
    pj, pt = ctx["pj"], ctx["pt"]
    lq = pt.max_level if level_q is None else level_q
    beta = -(-(lq + 1) // len(pt.p_moduli))
    assert_qp(jkeys._seeded_gadget_c1(pj, b"gk-seed", beta, lq)[-1],
              tkeys._seeded_gadget_c1(pt, b"gk-seed", beta, lq)[-1])
    mj, mt = ctx["sj"][1].value.q, ctx["st"][1].value.q
    with shared_draws(3):
        gj = ctx["kj"].gadget_encrypt(KEY, mj, ctx["sj"][0], level_q=level_q, seed=b"gk-seed")
        gt = ctx["kt"].gadget_encrypt(GEN, mt, ctx["st"][0], level_q=level_q, seed=b"gk-seed")
    assert_qp(gj.value, gt.value)
    cj, ct = jkeys.compress_gadget(gj, b"gk-seed"), tkeys.compress_gadget(gt, b"gk-seed")
    assert_qp(cj.c0, ct.c0)
    assert ct.seed == b"gk-seed" and ct.c0.q.shape == (beta, lq + 1, pt.n)
    assert_qp(cj.expand(pj).value, ct.expand(pt).value)
    assert torch.equal(ct.expand(pt).value.q, gt.value.q)
    assert torch.equal(ct.expand(pt).value.p, gt.value.p)
    with pytest.raises(ValueError):
        ctx["kt"].gadget_encrypt(GEN, mt, ctx["st"][0], row=1, seed=b"x")
    with pytest.raises(ValueError):
        ctx["kt"].gadget_encrypt(GEN, mt, ctx["st"][0], batch=(2,), seed=b"x")


def test_public_key_and_pk_encryption(ctx):
    pj, pt = ctx["pj"], ctx["pt"]
    with shared_draws(4):
        pk_j = ctx["kj"].gen_public_key(KEY, ctx["sj"][0])
        pk_t = ctx["kt"].gen_public_key(GEN, ctx["st"][0])
    assert_qp(pk_j.value, pk_t.value)
    assert pk_t.value.q.shape == (2, pt.max_level + 1, pt.n)
    enc = ctx["enc"]
    # a batch at the top level, one ciphertext at level 1; the JAX side
    # under one jax.jit each (the draws are read while it traces)
    for batch, m, level in (((2,), ctx["m"], pt.max_level), ((), ctx["m"][0], 1)):
        ptv = enc.encode(m).value[..., : level + 1, :]
        with shared_draws(5):
            cj = jax.jit(lambda v: jrlwe.Encryptor(pj, pk_j).encrypt(
                KEY, jrlwe.Plaintext(value=v, scale=1), batch=batch).value)(
                    jnp.asarray(interop.to_numpy(ptv)))
            ct = trlwe.Encryptor(pt, pk_t).encrypt(
                GEN, trlwe.Plaintext(value=ptv, scale=1), batch=batch)
        assert_same(cj, ct.value)
        assert ct.level == level and ct.is_ntt
        got = enc.decode(trlwe.Decryptor(pt, ctx["st"][0]).decrypt(ct))
        np.testing.assert_array_equal(got, m)


def test_evaluation_key(ctx):
    pj, pt = ctx["pj"], ctx["pt"]
    with shared_draws(6):
        ej = ctx["kj"].gen_evaluation_key(KEY, ctx["sj"][0], ctx["sj"][1])
        et = ctx["kt"].gen_evaluation_key(GEN, ctx["st"][0], ctx["st"][1])
    assert_qp(ej.gadget.value, et.gadget.value)
    enc = ctx["enc"]
    ct = trlwe.Encryptor(pt, ctx["st"][0]).encrypt(GEN, enc.encode(ctx["m"]), batch=(2,))
    out = tbgv.Evaluator(pt).apply_evaluation_key(ct, et)
    got = enc.decode(trlwe.Decryptor(pt, ctx["st"][1]).decrypt(out))
    np.testing.assert_array_equal(got, ctx["m"])
