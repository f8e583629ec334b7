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


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here, and
    they crowd the other test workers' cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module", params=[12, 13, 15, 16])
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


# logN: (launches a call, the splits the kernel has, least split, most
# split forward)
SPLIT_RANGE = {12: (1, (1, 2, 4, 8), 1, 2), 13: (1, (1, 2, 4, 8), 1, 4),
               15: (2, (2, 4, 8), 2, 8), 16: (2, (2, 4, 8), 4, 8)}


def test_split_range_by_ring(tables):
    """A block needs a 16-row slab of the split dimension: t1 (R rows)
    forward, j2 (C = 128 columns) inverse; at logN 12 and 13 two unsplit
    blocks already share an SM. At logN 15-16 (one launch a step) every
    slab at split 8 is 16 columns or more; two blocks share an SM from
    split 2 at logN 15 and from split 4 at logN 16."""
    eng, _ = tables
    launches, splits, least, most = SPLIT_RANGE[eng.logn]
    assert eng.launches_per_call == launches and eng.splits == splits
    assert eng.max_split(False) == most
    assert eng.max_split(True) == 8
    assert eng.min_split(False) == eng.min_split(True) == least
    assert tmxu.SPLITS == (1, 2, 4, 8)


@pytest.mark.parametrize("cc, split, want", [
    (128, 2, 256 // 2 * 528), (128, 4, 256 // 4 * 528), (128, 8, 256 // 8 * 528),
    (256, 2, 256 // 2 * 1040), (256, 4, 256 // 4 * 1040), (256, 8, 256 // 8 * 1040)])
def test_kernel_smem_steps(cc, split, want):
    """logN 15-16 (R = 256): a block of one step holds 1/split of its B
    columns with their whole contraction, (4A + 16) bytes a column: step 1
    forward C/split columns of 4R (step 2 inverse the same), step 2
    forward R/split columns of 4C (step 1 inverse the same); the larger
    of the two, in both directions."""
    rr = 256
    assert want == max(cc // split * (4 * rr + 16), rr // split * (4 * cc + 16))
    for inverse in (False, True):
        assert tmxu.kernel_smem(rr, cc, split, inverse) == want
    if cc == 256 and split == 2:
        # one block fills an SM, so the rule starts at 4 at logN 16
        assert 2 * (want + tmxu.SMEM_RESERVED_PER_BLOCK) > tmxu.SMEM_PER_SM


def test_unsplit_logn14_block_fills_an_sm():
    """At logN 14 one unsplit block takes 135168 bytes, so the rule starts
    at two blocks per (limb, polynomial)."""
    for inverse in (False, True):
        one = tmxu.kernel_smem(128, 128, 1, inverse)
        two = tmxu.kernel_smem(128, 128, 2, inverse)
        per_block = tmxu.SMEM_RESERVED_PER_BLOCK
        assert 2 * (one + per_block) > tmxu.SMEM_PER_SM
        assert 2 * (two + per_block) <= tmxu.SMEM_PER_SM


# -- the logN 15-16 step launches, emulated -------------------------------------

M32 = np.uint64(0xFFFFFFFF)


def _mred(a, b, q, qinv):
    """mred_lazy32 of the kernel on uint64 arrays holding u32 words."""
    hi = (a * b) >> np.uint64(32)
    m = ((a * b) & M32) * qinv & M32
    return hi - ((m * q) >> np.uint64(32)) + q


def _digits(v):
    """digits4 of the kernel: four int8 planes of words < 2^30."""
    out = []
    for _ in range(4):
        d = v & np.uint64(0xFF)
        out.append(d.astype(np.int16) - ((d >> np.uint64(7)).astype(np.int16) << 8))
        v = (v >> np.uint64(8)) + (d >> np.uint64(7))
    return [d.astype(np.int8) for d in out]


def _recombine(p, k):
    """recombine of the kernel on the four planes' int32 sums p[s]."""
    q, qinv, c24m, negb, _ = k
    u = [(ps.astype(np.int64) + (1 << 24)).astype(np.uint64) for ps in p]
    m16, m8 = np.uint64(0xFFFF), np.uint64(0xFF)
    lo = u[0] + ((u[1] & m16) << np.uint64(8)) + ((u[2] & m8) << np.uint64(16))
    hi = (u[1] >> np.uint64(16)) + (u[2] >> np.uint64(8)) + u[3]
    return (lo + _mred(hi, c24m, q, qinv) + negb) & M32


def _emulate_steps(eng, x, inverse, lazy, split):
    """``ntt_mxu_kernel_step`` on one (limb, polynomial) x (uint64 [N],
    limb 0), block by block: step 1's blocks fill the flat int8 scratch
    ``mid`` at the kernel's addresses, step 2's blocks read their slabs
    back from it and write the flat output. The products take the weight
    rows the kernel reads (its fragment-order tables, unpermuted)."""
    rr, cc, n = eng.rr, eng.cc, eng.n
    k = tuple(np.uint64(int(c) & 0xFFFFFFFF) for c in eng.consts[0, :5].numpy())
    q, qinv, _, _, onem = k
    a1, a2 = (cc, rr) if inverse else (rr, cc)
    w1 = _from_fragment_order((eng.w1i_mma if inverse else eng.w1f_mma)[0].numpy(),
                              4 * a1, 4 * a1).astype(np.float64)
    w2 = _from_fragment_order((eng.w2i_mma if inverse else eng.w2f_mma)[0].numpy(),
                              4 * a2, 4 * a2).astype(np.float64)
    tw = (eng.ti_t if inverse else eng.tf)[0].numpy().view(np.uint32).reshape(-1)
    tw = tw.astype(np.uint64)
    pl = rr if inverse else cc                    # a mid plane's bytes
    mid = np.zeros(4 * n, dtype=np.int8)
    out = np.zeros(n, dtype=np.uint64)
    v = _mred(x & M32, onem, q, qinv)
    # step 1: B columns forward j2 (C of them, K = (i, j1)), inverse t1
    cols1 = (rr if inverse else cc) // split
    for part in range(split):
        c0 = part * cols1
        if inverse:                               # smem[t][(i, t2)] = digits of x[c0 + t][t2]
            blk = v.reshape(rr, cc)[c0:c0 + cols1]
        else:                                     # smem[c][(i, j1)] = digits of x[j1][c0 + c]
            blk = v.reshape(rr, cc)[:, c0:c0 + cols1].T
        b = np.concatenate(_digits(blk), axis=1).astype(np.float64)   # [cols, 4 a1]
        p = (w1 @ b.T).astype(np.int64).reshape(4, a1, cols1)       # [s, a, c]
        a, c = np.meshgrid(np.arange(a1), c0 + np.arange(cols1), indexing="ij")
        d = _digits(_mred(_recombine(p, k), tw[a * pl + c], q, qinv))
        for i in range(4):
            mid[a * 4 * pl + i * pl + c] = d[i]
    # step 2: B columns forward t1 (K = (i, j2)), inverse j2 (K = (i, t1))
    cols2 = (cc if inverse else rr) // split
    for part in range(split):
        c0 = part * cols2
        b = mid[c0 * 4 * a2:(c0 + cols2) * 4 * a2].reshape(cols2, 4 * a2)
        p = (w2 @ b.T.astype(np.float64)).astype(np.int64).reshape(4, a2, cols2)
        f = _mred(_recombine(p, k), onem, q, qinv)
        if not lazy:
            f = np.where(f >= q, f - q, f)
        a, c = np.meshgrid(np.arange(a2), c0 + np.arange(cols2), indexing="ij")
        # forward a = t2, column t1: out[t1][t2]; inverse a = j1, column j2
        out[a * cc + c if inverse else c * cc + a] = f
    return out


@pytest.mark.parametrize("logn", [15, 16])
@pytest.mark.parametrize("inverse", [False, True])
def test_step_launches_emulated(logn, inverse):
    """At logN 15-16 the two step launches, emulated block by block at the
    least and the most split, equal the plain version, lazy and not, on an
    input whose low word sits at 0, q - 1, 2q - 1 and 2^32 - 1 in turns."""
    import torch

    n = 1 << logn
    q = NTTFriendlyPrimesGenerator(28, 2 * n).next_alternating_primes(1)[0]
    eng = tmxu.NTTMxu(n, [q], [primitive_nth_root(q, 2 * n)], "cpu")
    assert eng.launches_per_call == 2

    x = np.random.default_rng(eng.logn).integers(0, 1 << 62, eng.n, dtype=np.uint64)
    for i, low in enumerate((0, q - 1, 2 * q - 1, (1 << 32) - 1)):
        x[i::4] = (x[i::4] & ~M32) | np.uint64(low)
    for lazy in (False, True):
        want = tmxu.four_step_plain(eng, torch.from_numpy(x.view(np.int64))[None, None],
                                    0, inverse, lazy).numpy().reshape(-1)
        for split in (eng.min_split(inverse), eng.max_split(inverse)):
            got = _emulate_steps(eng, x, inverse, lazy, split)
            np.testing.assert_array_equal(got.view(np.int64), want)
