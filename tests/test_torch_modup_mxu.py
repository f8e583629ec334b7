"""Port parity: the ModUp digit-matmul contraction against lattigo_tpu.

The port runs the ModUp limb contraction as one exact int8 matmul when
every modulus is < 2^29 and 6 ≤ Li ≤ 256, on every device (the JAX
package does so on a TPU only). Held here, tolerance 0:

* ``_mod_up_contract_mxu`` against ``lattigo_tpu.ring.basis_extension.
  _mod_up_contract_mxu``, called as ``tests/test_rns.py`` calls it (the JAX
  side jitted), at Li = 6 and 13 and at odd Li and Lj, which pad the
  matmul's K = 4·Li and N = 4·Lj to multiples of 8;
* the weight digits against the JAX package's ``w_mxu`` (padding cut);
* ``mod_up`` (centered and floor) against the JAX package's ``mod_up``,
  which on the CPU runs the raw multiply-accumulate, and against the
  port's own raw MAC on the same constants;
* the gadget ``Decomposer.decompose_all`` with α = 6, whose full digits
  take the contraction and whose last digit (2 limbs) the raw MAC;
* the BGV decode's Q → {T} conversion (T = 65537) through ``mod_up``.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lattigo_tpu.ring import basis_extension as jbe
from lattigo_tpu.ring import modops as jmodops
from lattigo_tpu.ring.ring import Ring as JRing
from lattigo_tpu.utils.primes import NTTFriendlyPrimesGenerator
from lattigo_tpu_torch.interop import to_numpy, to_torch
from lattigo_tpu_torch.ring import basis_extension as tbe
from lattigo_tpu_torch.ring.ring import Ring as TRing, u64_tensor

N = 512


def _primes(bits: int, k: int) -> list[int]:
    """k NTT-friendly primes of ``bits`` bits below 2^bits."""
    gen = NTTFriendlyPrimesGenerator(bits, 2 * N)
    return [gen.next_downstream_prime() for _ in range(k)]


def _canonical(rng, moduli, batch):
    y = np.stack([rng.integers(0, q, batch + (N,), dtype=np.uint64) for q in moduli],
                 axis=-2)
    y[..., :4] = np.array(moduli, dtype=np.uint64)[:, None] - 1
    return y


def _dst_tables(dst):
    """(q, qinv, bred_hi) of dst as uint64 [Lj, 1] arrays."""
    return tuple(np.array(v, dtype=np.uint64)[:, None] for v in (
        dst, [jmodops.gen_mred_constant(p) for p in dst],
        [jmodops.gen_bred_constant(p)[0] for p in dst]))


@pytest.mark.parametrize("li, lj", [(6, 2), (13, 1), (13, 2), (7, 3), (9, 5)])
def test_contraction_vs_jax(li, lj):
    ps = _primes(28, li + lj)
    src, dst = ps[:li], ps[li:]
    jc, tc = jbe.ModUpConstants(src, dst), tbe.ModUpConstants(src, dst, "cpu")
    assert jc.mxu and tc.mxu
    assert (tc.li_pad, tc.lj_pad) == (li + li % 2, lj + lj % 2)
    w = tc.w_mxu.numpy().reshape(4, tc.li_pad, 4, tc.lj_pad)
    np.testing.assert_array_equal(w[:, :li, :, :lj].reshape(4 * li, 4 * lj), jc.w_mxu)
    assert not w[:, li:].any() and not w[..., lj:].any()
    rng = np.random.default_rng(li * 16 + lj)
    y = _canonical(rng, src, (3,))
    v = rng.integers(0, li + 1, (3, N), dtype=np.uint64)
    dq, _, dbhi = _dst_tables(dst)
    want = np.asarray(jax.jit(lambda a, b: jbe._mod_up_contract_mxu(
        a, b, jc, dq, dbhi))(jnp.asarray(y), jnp.asarray(v)))
    got = tbe._mod_up_contract_mxu(to_torch(y, "cpu"), to_torch(v, "cpu"), tc,
                                   to_torch(dq, "cpu"), to_torch(dbhi, "cpu"))
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("li, lj", [(6, 2), (13, 1), (7, 3)])
@pytest.mark.parametrize("centered", [True, False])
def test_mod_up_vs_jax_and_raw_mac(li, lj, centered):
    ps = _primes(29, li + lj)
    assert max(ps) < 1 << 29
    src, dst = ps[:li], ps[li:]
    jc, tc = jbe.ModUpConstants(src, dst), tbe.ModUpConstants(src, dst, "cpu")
    rng = np.random.default_rng(li + lj)
    x = _canonical(rng, src, (2,))
    tabs = _dst_tables(dst)
    want = np.asarray(jax.jit(lambda a: jbe.mod_up(a, jc, *tabs, centered))(jnp.asarray(x)))
    targs = tuple(to_torch(t, "cpu") for t in tabs)
    got = tbe.mod_up(to_torch(x, "cpu"), tc, *targs, centered)
    np.testing.assert_array_equal(to_numpy(got), want)
    raw = copy.copy(tc)
    raw.mxu = False
    assert torch.equal(tbe.mod_up(to_torch(x, "cpu"), raw, *targs, centered), got)


def test_decompose_all_vs_jax():
    q, p = _primes(28, 8), _primes(27, 6)
    jq, jp = JRing(N, q), JRing(N, p)
    tq, tp = TRing(N, q, device="cpu"), TRing(N, p, device="cpu")
    jdec, tdec = jbe.Decomposer(jq, jp), tbe.Decomposer(tq, tp)
    level = 7
    assert tdec._get_consts(level, 0).mxu and not tdec._get_consts(level, 1).mxu
    x = _canonical(np.random.default_rng(5), q, (2,))
    wq, wp = jax.jit(lambda v: jdec.decompose_all(v, level))(x)
    gq, gp = tdec.decompose_all(to_torch(x, "cpu"), level)
    np.testing.assert_array_equal(to_numpy(gq), np.asarray(wq))
    np.testing.assert_array_equal(to_numpy(gp), np.asarray(wp))


def test_decode_q_to_t_vs_jax():
    t = 0x10001
    src = _primes(28, 12)
    jc, tc = jbe.ModUpConstants(src, [t]), tbe.ModUpConstants(src, [t], "cpu")
    assert tc.mxu and tc.lj_pad == 2
    x = _canonical(np.random.default_rng(7), src, (4,))
    tabs = _dst_tables([t])
    want = np.asarray(jax.jit(lambda a: jbe.mod_up(a, jc, *tabs, True))(jnp.asarray(x)))
    got = tbe.mod_up(to_torch(x, "cpu"), tc, *(u64_tensor(v, "cpu") for v in tabs))
    np.testing.assert_array_equal(to_numpy(got), want)
