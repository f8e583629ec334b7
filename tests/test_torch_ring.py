"""Port parity: RNS basis extension and rescaling against lattigo_tpu.

mod_up, the gadget Decomposer, mod_down_qp_to_q and div_by_last_modulus
on a 28-bit chain (raw-MAC ModUp, four-step NTT engine in the port) and on
a 40/45-bit chain (Montgomery ModUp, radix-2 engine), plus the
``prereduce_src`` cross-size case (source primes ≥ 2^52 into {T}). Every
comparison is exact.
"""

import numpy as np
import jax
import pytest

from lattigo_tpu.ring import basis_extension as jbe
from lattigo_tpu.ring import scaling as jsc
from lattigo_tpu.ring.ring import Ring as JRing
from lattigo_tpu.utils.primes import NTTFriendlyPrimesGenerator
from lattigo_tpu_torch.interop import to_numpy, to_torch
from lattigo_tpu_torch.ring import basis_extension as tbe
from lattigo_tpu_torch.ring import scaling as tsc
from lattigo_tpu_torch.ring.ring import Ring as TRing

CHAINS = {
    "28bit": (4096, (28,) * 4, (28, 28)),
    "40bit": (256, (40,) * 4, (45, 45)),
}


def _draw(n, log_q, log_p):
    gens = {}
    out = []
    for b in log_q + log_p:
        gens.setdefault(b, NTTFriendlyPrimesGenerator(b, 2 * n))
        out.append(gens[b].next_alternating_prime())
    return out[:len(log_q)], out[len(log_q):]


@pytest.fixture(scope="module", params=sorted(CHAINS))
def chain(request):
    n, log_q, log_p = CHAINS[request.param]
    q, p = _draw(n, log_q, log_p)
    jq, jp = JRing(n, q), JRing(n, p)
    tq, tp = TRing(n, q, device="cpu"), TRing(n, p, device="cpu")
    return dict(n=n, q=q, p=p, jq=jq, jp=jp, tq=tq, tp=tp,
                jbe=jbe.BasisExtender(jq, jp), tbe=tbe.BasisExtender(tq, tp),
                jdec=jbe.Decomposer(jq, jp), tdec=tbe.Decomposer(tq, tp),
                rng=np.random.default_rng(len(q) + n))


def _residues(rng, moduli, batch, n):
    m = np.array(moduli, dtype=np.uint64)[:, None]
    return rng.integers(0, 1 << 62, batch + (len(moduli), n), dtype=np.uint64) % m


def _t(x):
    return to_torch(x, "cpu")


def test_mod_up(chain):
    c = chain
    for level in (1, 3):
        x = _residues(c["rng"], c["q"][: level + 1], (2,), c["n"])
        want = np.asarray(jax.jit(lambda v: c["jbe"].mod_up_q_to_p(v, level))(x))
        np.testing.assert_array_equal(
            to_numpy(c["tbe"].mod_up_q_to_p(_t(x), level)), want)
    xp = _residues(c["rng"], c["p"], (2,), c["n"])
    want = np.asarray(jax.jit(lambda v: c["jbe"].mod_up_p_to_q(v, 3))(xp))
    np.testing.assert_array_equal(to_numpy(c["tbe"].mod_up_p_to_q(_t(xp), 3)), want)


def test_decomposer(chain):
    c = chain
    level = 3
    x = _residues(c["rng"], c["q"], (2,), c["n"])
    wq, wp = jax.jit(lambda v: c["jdec"].decompose_all(v, level))(x)
    gq, gp = c["tdec"].decompose_all(_t(x), level)
    np.testing.assert_array_equal(to_numpy(gq), np.asarray(wq))
    np.testing.assert_array_equal(to_numpy(gp), np.asarray(wp))
    wq, wp = jax.jit(lambda v: c["jdec"].decompose_single(v, level, 1))(x)
    gq, gp = c["tdec"].decompose_single(_t(x), level, 1)
    np.testing.assert_array_equal(to_numpy(gq), np.asarray(wq))
    np.testing.assert_array_equal(to_numpy(gp), np.asarray(wp))


@pytest.mark.parametrize("ntt_domain", [False, True])
def test_mod_down(chain, ntt_domain):
    c = chain
    level = 2
    xq = _residues(c["rng"], c["q"][: level + 1], (2,), c["n"])
    xp = _residues(c["rng"], c["p"], (2,), c["n"])
    want = np.asarray(jax.jit(lambda a, b: c["jbe"].mod_down_qp_to_q(
        a, b, level, ntt_domain=ntt_domain))(xq, xp))
    got = c["tbe"].mod_down_qp_to_q(_t(xq), _t(xp), level, ntt_domain=ntt_domain)
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("ntt_domain", [False, True])
@pytest.mark.parametrize("round_div", [False, True])
def test_div_by_last_modulus(chain, ntt_domain, round_div):
    c = chain
    x = _residues(c["rng"], c["q"], (2,), c["n"])
    want = np.asarray(jax.jit(lambda v: jsc.div_by_last_modulus(
        c["jq"], v, 3, ntt_domain=ntt_domain, round_div=round_div))(x))
    got = tsc.div_by_last_modulus(c["tq"], _t(x), 3, ntt_domain=ntt_domain,
                                  round_div=round_div)
    np.testing.assert_array_equal(to_numpy(got), want)


def test_prereduce_src():
    n = 256
    src = NTTFriendlyPrimesGenerator(55, 2 * n).next_alternating_primes(3)
    t = 65537
    jc = jbe.ModUpConstants(src, [t])
    tc = tbe.ModUpConstants(src, [t], "cpu")
    assert jc.prereduce_src and tc.prereduce_src
    jt, tt = JRing(n, [t]), TRing(n, [t], device="cpu")
    x = _residues(np.random.default_rng(7), src, (2,), n)
    want = np.asarray(jax.jit(lambda v: jbe.mod_up(
        v, jc, jt.q, jt.qinv, jt.bred_hi))(x))
    got = tbe.mod_up(_t(x), tc, tt.q, tt.qinv, tt.bred_hi)
    np.testing.assert_array_equal(to_numpy(got), want)
    # the centered conversion of x mod Q, reduced mod T
    Q = src[0] * src[1] * src[2]
    for j in range(4):
        v = sum(int(x[0, i, j]) * (Q // q) * pow(Q // q, -1, q)
                for i, q in enumerate(src)) % Q
        v = v - Q if v > Q // 2 else v
        assert int(to_numpy(got)[0, 0, j]) == v % t
