"""The four-step kernel's host-side layout, on the CPU.

``csrc/ntt_mxu.cu`` reads its weight digits in the order of its
``mma.m16n8k32`` A fragments (``ntt_mxu.mma_fragment_order``). These tests
hold that order against the PTX ISA's fragment layout, hold its inverse
against ``lattigo_tpu.ring.ntt_mxu.gen_mxu_tables`` for every weight table
the kernel reads, and check the split rule that picks the blocks per
(limb, polynomial). Comparisons are exact (integer tables).
"""

import numpy as np
import pytest

from lattigo_tpu.ring import ntt_mxu as jmxu
from lattigo_tpu.utils.primes import NTTFriendlyPrimesGenerator
from lattigo_tpu_torch.ring import ntt_mxu as tmxu
from lattigo_tpu_torch.utils.primes import primitive_nth_root


def _from_fragment_order(f, m, k):
    """Inverse of mma_fragment_order for one [m, k] table."""
    v = f.reshape(m // 16, k // 32, 8, 4, 2, 2, 4)   # tile, step, g, t, half, h, byte
    return v.transpose(0, 5, 2, 1, 4, 3, 6).reshape(m, k)


def test_fragment_order_is_the_ptx_a_layout():
    """Lane 4g + t of tile (mt, ks) holds registers a0..a3 of the PTX ISA's
    m16n8k32 .s8 A fragment: element i of the 16 at row g (i < 4 or
    8 <= i < 12) or g + 8, column 4t + (i & 3) (+ 16 for i >= 8)."""
    rng = np.random.default_rng(5)
    m, k = 64, 96
    w = rng.integers(-128, 128, (m, k)).astype(np.int8)
    f = tmxu.mma_fragment_order(w).reshape(m // 16, k // 32, 32, 16)
    for mt in range(m // 16):
        for ks in range(k // 32):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for i in range(16):
                    row = g if (i < 4 or 8 <= i < 12) else g + 8
                    col = 4 * t + (i & 3) + (16 if i >= 8 else 0)
                    assert f[mt, ks, lane, i] == w[16 * mt + row, 32 * ks + col]


@pytest.fixture(scope="module", params=[12, 13])
def tables(request):
    logn = request.param
    n = 1 << logn
    q = NTTFriendlyPrimesGenerator(28, 2 * n).next_alternating_primes(2)[1]
    psi = primitive_nth_root(q, 2 * n)
    cc = max(128, 1 << (logn // 2))
    rr = n // cc
    eng = tmxu.NTTMxu(n, [q], [psi], "cpu")
    return eng, jmxu.gen_mxu_tables(n, rr, cc, psi, q)


# kernel table, the JAX package's table, whether the kernel reads it transposed
KERNEL_TABLES = [("w1f_mma", "w1f", False), ("w2f_mma", "w2f", True),
                 ("w1i_mma", "w1i", True), ("w2i_mma", "w2i", False)]


@pytest.mark.parametrize("name, key, transposed", KERNEL_TABLES)
def test_fragment_tables_invert_to_gen_mxu_tables(tables, name, key, transposed):
    eng, want = tables
    w = want[key].astype(np.int8)
    if transposed:
        w = w.T
    got = getattr(eng, name).numpy()
    assert got.shape == (1, w.size) and got.dtype == np.int8
    np.testing.assert_array_equal(_from_fragment_order(got[0], *w.shape), w)
    np.testing.assert_array_equal(
        got[0], tmxu.mma_fragment_order(w[None])[0])


def test_split_rule():
    sms = 132
    assert tmxu.pick_split(60, sms, 1, 8) == 4        # 4 x 15 limbs
    assert tmxu.pick_split(4, sms, 1, 8) == 8         # one limb of 4 polys
    assert tmxu.pick_split(4, sms, 1, 2) == 2         # capped
    assert tmxu.pick_split(132, sms, 1, 8) == 1
    assert tmxu.pick_split(364, sms, 2, 8) == 2       # floored
    assert tmxu.pick_split(34, sms, 1, 8) == 4
    assert tmxu.pick_split(0, sms, 1, 8) == 8


@pytest.mark.parametrize("logn, inverse, want", [
    (12, False, 128 * 144 + 32 * 528), (12, True, 32 * 528 + 128 * 144),
    (14, False, 128 * 528 + 128 * 528), (14, True, 128 * 528 + 128 * 528)])
def test_kernel_smem(logn, inverse, want):
    """The kernel's Layout: input digits C x (4R + 16) forward, R x (4C +
    16) inverse, plus step 1's digits for the block's share of the split
    dimension."""
    cc = 128
    rr = (1 << logn) // cc
    assert tmxu.kernel_smem(rr, cc, 1, inverse) == want
    halves = tmxu.kernel_smem(rr, cc, 2, inverse)
    assert want - halves == (rr * (4 * cc + 16) if not inverse
                             else cc * (4 * rr + 16)) // 2


def test_split_range_by_ring(tables):
    """A block needs a 16-row slab of the split dimension: t1 (R rows)
    forward, j2 (C = 128 columns) inverse; at logN 12 and 13 two unsplit
    blocks already share an SM."""
    eng, _ = tables
    assert eng.max_split(False) == eng.rr // 16
    assert eng.max_split(True) == 8
    assert eng.min_split(False) == eng.min_split(True) == 1
    assert tmxu.SPLITS == (1, 2, 4, 8)


def test_unsplit_logn14_block_fills_an_sm():
    """At logN 14 one unsplit block takes 135168 bytes, so the rule starts
    at two blocks per (limb, polynomial)."""
    for inverse in (False, True):
        one = tmxu.kernel_smem(128, 128, 1, inverse)
        two = tmxu.kernel_smem(128, 128, 2, inverse)
        per_block = tmxu.SMEM_RESERVED_PER_BLOCK
        assert 2 * (one + per_block) > tmxu.SMEM_PER_SM
        assert 2 * (two + per_block) <= tmxu.SMEM_PER_SM
