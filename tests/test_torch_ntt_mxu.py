"""The four-step kernel's host-side layout, on the CPU.

``csrc/ntt_mxu.cu`` reads its weight digits, up to logN 14, in the order
of its ``mma.m16n8k32`` A fragments (``ntt_mxu.mma_fragment_order``), and
at logN 15-16 as 16 KB ``wgmma`` tiles (``ntt_mxu.wgmma_tile_order``).
These tests hold both orders against the PTX ISA's layouts, hold their
inverses against ``lattigo_tpu.ring.ntt_mxu.gen_mxu_tables`` for every
weight table the kernel reads, check the rules that pick the blocks per
(limb, polynomial) and the cluster size, and emulate the logN 15-16
cluster kernel block by block against the plain version. Comparisons are
exact (integer tables).
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


def _from_tile_order(f, m):
    """Inverse of wgmma_tile_order for one [m, m] table (m = 4A)."""
    a = m // 4
    aj, kc = a // 8, 2 * tmxu.TILE_BYTES // a
    v = f.reshape(8, m // kc, 4, aj // 8, kc // 16, 8, 16)  # job, tile, s, n8, core, row, byte
    return v.transpose(2, 0, 3, 5, 1, 4, 6).reshape(m, m)


# kernel table, the JAX package's table, whether the kernel reads it transposed
KERNEL_TABLES = [("w1f", "w1f", False), ("w2f", "w2f", True),
                 ("w1i", "w1i", True), ("w2i", "w2i", False)]


@pytest.mark.parametrize("name, key, transposed", KERNEL_TABLES)
def test_fragment_tables_invert_to_gen_mxu_tables(tables, name, key, transposed):
    """The kernel's tables (``NTTMxu.kernel_tables``) are in mma fragment
    order up to logN 14 and in wgmma tile order at 15-16."""
    eng, want = tables
    w = want[key].astype(np.int8)
    if transposed:
        w = w.T
    fused = eng.n <= tmxu.FUSED_MAX_N
    got = eng.kernel_tables[[n for n, _, _ in KERNEL_TABLES].index(name)].numpy()
    assert got.shape == (1, w.size) and got.dtype == np.int8
    if fused:
        np.testing.assert_array_equal(_from_fragment_order(got[0], *w.shape), w)
        np.testing.assert_array_equal(got[0], tmxu.mma_fragment_order(w[None])[0])
    else:
        np.testing.assert_array_equal(_from_tile_order(got[0], w.shape[0]), w)
        np.testing.assert_array_equal(got[0], tmxu.wgmma_tile_order(w[None])[0])


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


# logN: (launches a call, the splits or cluster sizes the kernel has,
# least, most forward)
SPLIT_RANGE = {12: (1, (1, 2, 4, 8), 1, 2), 13: (1, (1, 2, 4, 8), 1, 4),
               15: (1, (2, 4, 8), 2, 8), 16: (1, (4, 8), 4, 8)}


def test_split_range_by_ring(tables):
    """A block needs a 16-row slab of the split dimension: t1 (R rows)
    forward, j2 (C = 128 columns) inverse; at logN 12 and 13 two unsplit
    blocks already share an SM. At logN 15-16 (one launch a call on a
    cluster) a block holds 64 KB of a step's digits: a cluster takes
    N / 2^14 blocks or more (2 at logN 15, 4 at 16), at most 8."""
    eng, _ = tables
    launches, splits, least, most = SPLIT_RANGE[eng.logn]
    assert eng.launches_per_call == launches and eng.splits == splits
    assert eng.max_split(False) == most
    assert eng.max_split(True) == 8
    assert eng.min_split(False) == eng.min_split(True) == least
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




@pytest.mark.parametrize("logn, rows, limbs", [(15, 124, 31), (16, 124, 62), (16, 256, 1),
                                               (16, 21, 3), (15, 3, 3)])
def test_split_for_clusters(logn, rows, limbs):
    """Above logN 14 a call runs on the least cluster, N / 2^14 blocks (one
    polynomial a cluster): whatever the call, its grid has the fewest
    blocks there, limbs * ceil(polys / G) * S with G = S * 2^14 / N."""
    n = 1 << logn
    q = NTTFriendlyPrimesGenerator(28, 2 * n).next_alternating_primes(1)[0]
    eng = tmxu.NTTMxu(n, [q], [primitive_nth_root(q, 2 * n)], "cpu")
    polys = rows // limbs
    blocks = {s: limbs * -(-polys // (s * (1 << 14) // n)) * s for s in eng.splits}
    for inverse in (False, True):
        size = eng.split_for(rows, inverse)
        assert size == n >> 14 == eng.min_split(inverse)
        assert blocks[size] == min(blocks.values())


# -- the logN 15-16 cluster kernel, emulated --------------------------------------

M32 = np.uint64(0xFFFFFFFF)
SLAB = 65536


def _mred(a, b, q, qinv):
    """mred_lazy32 of the kernel on uint64 arrays holding u32 words."""
    hi = (a * b) >> np.uint64(32)
    m = ((a * b) & M32) * qinv & M32
    return hi - ((m * q) >> np.uint64(32)) + q


def _digit_bytes(v):
    """digits4 of the kernel: the four digit bytes (uint32, < 256) of words
    < 2^30."""
    out = []
    for _ in range(4):
        d = v & np.uint64(0xFF)
        out.append(d.astype(np.uint32))
        v = (v >> np.uint64(8)) + (d >> np.uint64(7))
    return out


def _recombine(p, k):
    """recombine of the kernel on the four planes' int32 sums p[s]."""
    q, qinv, c24m, negb, _ = k
    u = [(ps.astype(np.int64) + (1 << 24)).astype(np.uint64) for ps in p]
    m16, m8 = np.uint64(0xFFFF), np.uint64(0xFF)
    lo = u[0] + ((u[1] & m16) << np.uint64(8)) + ((u[2] & m8) << np.uint64(16))
    hi = (u[1] >> np.uint64(16)) + (u[2] >> np.uint64(8)) + u[3]
    return (lo + _mred(hi, c24m, q, qinv) + negb) & M32


def _slab_off(col, k, kbytes):
    """slab_off of the kernel: column col, K byte k of a slab of kbytes a
    column (columns paired within each 16: c at row c / 2 + 8 (c & 1))."""
    row = (col & ~15) | ((col & 15) >> 1) | ((col & 1) << 3)
    return (row >> 3) * 8 * kbytes + (k >> 4) * 128 + (row & 7) * 16 + (k & 15)


def _desc_read(smem, start, sbo, rows):
    """The [rows, 32] s8 operand one wgmma reads through a descriptor at
    ``start`` (PTX ISA, K-major without swizzle: core matrices of 8 rows x
    16 bytes, row r of one at 16 r; K-adjacent cores LBO = 128 bytes
    apart, 8-row groups SBO apart)."""
    r = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    return smem[start + (r // 8) * sbo + (r % 8) * 16 + (k // 16) * 128 + k % 16].view(np.int8)


def _step(a):
    """StepShape<A> of the kernel: 8 jobs of A/2 rows (s, a), a < A/8."""
    aj = a // 8
    kc = 2 * tmxu.TILE_BYTES // a
    return dict(jobs=8, aj=aj, j8=aj // 8, k=4 * a, ng=256 // a, kc=kc,
                nkc=4 * a // kc, ks=kc // 32)


@pytest.mark.parametrize("a", [128, 256])
def test_wgmma_tile_order_is_the_ptx_b_layout(a):
    """Tile (job, kc) of wgmma_tile_order, read k step by k step through the
    kernel's descriptors (start tile + 256 ks, SBO 8 KC), is the wgmma B
    operand of rows n = s * A/8 + r: row s * A + job * A/8 + r of the table
    at K bytes kc * KC + 32 ks .. + 31."""
    rng = np.random.default_rng(a)
    w = rng.integers(-128, 128, (4 * a, 4 * a)).astype(np.int8)
    t = tmxu.wgmma_tile_order(w).view(np.uint8)
    st = _step(a)
    n = np.arange(a // 2)
    rows_of = (n // st["aj"]) * a + n % st["aj"]
    for job in range(st["jobs"]):
        for kc in range(st["nkc"]):
            base = (job * st["nkc"] + kc) * tmxu.TILE_BYTES
            for ks in range(st["ks"]):
                got = _desc_read(t, base + 256 * ks, 8 * st["kc"], a // 2)
                k0 = kc * st["kc"] + 32 * ks
                np.testing.assert_array_equal(got, w[job * st["aj"] + rows_of, k0:k0 + 32])


@pytest.mark.parametrize("kbytes", [512, 1024])
def test_slab_offsets_are_the_ptx_a_layout(kbytes):
    """The slabs' slab_off against the wgmma A operand the kernel reads:
    the descriptor at slab + cg * 8 SBO + 256 * (k step), SBO = 8 K, reads
    row m of column group cg as column 64 cg + c with c / 2 + 8 (c & 1) = m
    within each 16 (rows g and g + 8 of a thread are columns 2g, 2g + 1);
    every byte of the 64 KB slab is some (column, K byte)."""
    cols = SLAB // kbytes
    smem = np.zeros(SLAB, dtype=np.uint8)
    col, k = np.meshgrid(np.arange(cols), np.arange(kbytes), indexing="ij")
    offs = _slab_off(col, k, kbytes)
    assert np.array_equal(np.sort(offs.reshape(-1)), np.arange(SLAB))
    vals = (col * 7 + k * 3) % 256
    smem[offs] = vals
    for cg in range(cols // 64):
        m = np.arange(64)
        c = 64 * cg + 16 * (m // 16) + 2 * (m % 8) + (m % 16) // 8
        for ks in range(kbytes // 32):
            got = _desc_read(smem, cg * 8 * 8 * kbytes + 256 * ks, 8 * kbytes, 64)
            np.testing.assert_array_equal(got.view(np.uint8), vals[c, 32 * ks:32 * ks + 32])


@pytest.mark.parametrize("logn, size", [(15, 2), (15, 4), (15, 8), (16, 4), (16, 8)])
def test_cluster_shapes(logn, size):
    """ClusterShape of the kernel: G = S * 2^14 / N polynomials a cluster,
    each step's slab 64 KB (G * CW * 4A bytes, CW = A_other / S columns of
    a polynomial, whole 16-column groups), and a block's shared memory
    within the 227 KB an H100 block may take, one block an SM."""
    n = 1 << logn
    cc = 256 if logn == 16 else 128
    g = size * (1 << 14) // n
    assert g >= 1
    for inverse in (False, True):
        a1, a2 = (cc, 256) if inverse else (256, cc)
        cw1, cw2 = a2 // size, a1 // size
        assert g * cw1 * 4 * a1 == SLAB == g * cw2 * 4 * a2
        assert cw1 % 16 == 0 and cw2 % 16 == 0
        assert 64 * _step(a1)["ng"] == g * cw1 and 64 * _step(a2)["ng"] == g * cw2
        assert tmxu.kernel_smem(256, cc, size, inverse) == tmxu.CLUSTER_SMEM
    assert tmxu.CLUSTER_SMEM <= 232448
    assert 2 * (tmxu.CLUSTER_SMEM + tmxu.SMEM_RESERVED_PER_BLOCK) > tmxu.SMEM_PER_SM


def _emulate_cluster(eng, x, inverse, size):
    """``ntt_mxu_cluster_kernel`` on x (uint64 [polys, N], limb 0) at
    cluster size ``size``, cluster by cluster and block by block, at the
    kernel's addresses: the entry digits into each block's step-1 slab,
    every wgmma of every job through its descriptors on weight tiles
    assembled from the S multicast slices of the table in tile order, step
    1's epilogue thread by thread (the lane-pair swap included) storing
    words into the owning block's step-2 slab, then step 2 and its int64
    stores. Returns the output before the lazy / full normalisation's last
    subtraction: (value in [0, 2q), q)."""
    rr, cc, n = eng.rr, eng.cc, eng.n
    k = tuple(np.uint64(int(c) & 0xFFFFFFFF) for c in eng.consts[0, :5].numpy())
    q, qinv, _, _, onem = k
    a1, a2 = (cc, rr) if inverse else (rr, cc)
    g = size * (1 << 14) // n
    cw1, cw2 = a2 // size, a1 // size
    w1f, w2f, w1i, w2i = eng.kernel_tables
    tables = [t[0].numpy().view(np.uint8) for t in ((w1i, w2i) if inverse else (w1f, w2f))]
    tw = (eng.ti_t if inverse else eng.tf)[0].numpy().view(np.uint32).reshape(-1).astype(np.uint64)
    polys = x.shape[0]
    out = np.zeros((polys, n), dtype=np.uint64)
    # a thread's coordinates: warp in its group wq, lane (g8, t4), n8 block jj
    def lanes(j8):
        wq, g8, t4, jj = np.meshgrid(np.arange(4), np.arange(8), np.arange(4),
                                     np.arange(j8), indexing="ij")
        return wq, g8, t4, jj

    def products(slab, table, a, jb):
        """The accumulators D[cg] (64 x A/2) of job jb: every tile of it,
        every k step, through the kernel's descriptors (float64 sums of
        int8 products, exact below 2^53)."""
        st = _step(a)
        acc = np.zeros((st["ng"], 64, a // 2))
        for kc in range(st["nkc"]):
            src = (jb * st["nkc"] + kc) * tmxu.TILE_BYTES
            slice_ = tmxu.TILE_BYTES // size
            stage = np.concatenate([table[src + r * slice_:src + (r + 1) * slice_]
                                    for r in range(size)])
            for ks in range(st["ks"]):
                b = _desc_read(stage, 256 * ks, 8 * st["kc"], a // 2).astype(np.float64)
                ka = (kc * st["kc"] // 16 + 2 * ks) * 128
                for cg in range(st["ng"]):
                    am = _desc_read(slab, ka + cg * 8 * 8 * st["k"], 8 * st["k"], 64)
                    acc[cg] += am.astype(np.float64) @ b.T
        return acc.astype(np.int64)

    for p0 in range(0, polys, g):
        slab1 = [np.zeros(SLAB, dtype=np.uint8) for _ in range(size)]
        slab2 = [np.zeros(SLAB, dtype=np.uint8) for _ in range(size)]
        written = [np.zeros(SLAB, dtype=np.int64) for _ in range(size)]
        # entry digits
        for rank in range(size):
            it = np.arange(g * cw1 * a1 // 4)
            cb = g * cw1 // 8
            col = (it & 7) | (((it >> 5) % cb) << 3)
            kk = 4 * (((it >> 3) & 3) | (((it >> 5) // cb) << 2))
            p = p0 + col // cw1
            c1 = rank * cw1 + col % cw1
            valid = p < polys
            pk = [np.zeros(it.size, dtype=np.uint32) for _ in range(4)]
            for j in range(4):
                idx = c1 * cc + kk + j if inverse else (kk + j) * cc + c1
                xv = np.where(valid, x[np.minimum(p, polys - 1), idx], 0)
                d = _digit_bytes(_mred(xv & M32, onem, q, qinv))
                for i in range(4):
                    pk[i] |= np.where(valid, d[i], 0).astype(np.uint32) << np.uint32(8 * j)
            for i in range(4):
                off = _slab_off(col, i * a1 + kk, 4 * a1)
                slab1[rank].view(np.uint32)[off // 4] = pk[i]
        # step 1 and its epilogue
        st = _step(a1)
        for rank in range(size):
            for jb in range(st["jobs"]):
                acc = products(slab1[rank], tables[0], a1, jb)
                wq, g8, t4, jj = lanes(st["j8"])
                odd = g8 & 1
                for cg in range(st["ng"]):
                    colb = 64 * cg + 16 * wq + 2 * g8
                    poly = colb // cw1
                    col = rank * cw1 + colb % cw1
                    pk = np.zeros((2, 4) + wq.shape, dtype=np.uint32)
                    for e in range(2):
                        a = jb * st["aj"] + 8 * jj + 2 * t4 + e
                        for h in range(2):
                            m = 16 * wq + g8 + 8 * h
                            planes = [acc[cg][m, s * st["aj"] + 8 * jj + 2 * t4 + e]
                                      for s in range(4)]
                            v = _mred(_recombine(planes, k), tw[a * a2 + col + h], q, qinv)
                            for i, d in enumerate(_digit_bytes(v)):
                                pk[e, i] |= d << np.uint32(8 * h)
                    keep = odd
                    send = [np.where(keep == 1, pk[0, i], pk[1, i]) for i in range(4)]
                    # the partner of (wq, g8, t4, jj) is (wq, g8 ^ 1, t4, jj)
                    partner = np.arange(8) ^ 1
                    got = [s_[:, partner] for s_ in send]
                    a = jb * st["aj"] + 8 * jj + 2 * t4 + keep
                    owner = a // cw2
                    col2 = poly * cw2 + a % cw2
                    for i in range(4):
                        word = np.where(keep == 1, got[i] | pk[1, i] << np.uint32(16),
                                        pk[0, i] | got[i] << np.uint32(16))
                        off = _slab_off(col2, i * a2 + (col & ~3), 4 * a2)
                        assert np.all(off % 4 == 0)
                        for o in range(size):
                            sel = owner == o
                            slab2[o].view(np.uint32)[off[sel] // 4] = word[sel]
                            np.add.at(written[o], off[sel], 1)
        for o in range(size):                    # every word of every slab, once
            assert np.array_equal(written[o][::4], np.ones(SLAB // 4, dtype=np.int64))
        # step 2 and its stores
        st = _step(a2)
        for rank in range(size):
            for jb in range(st["jobs"]):
                acc = products(slab2[rank], tables[1], a2, jb)
                wq, g8, t4, jj = lanes(st["j8"])
                for cg in range(st["ng"]):
                    colb = 64 * cg + 16 * wq + 2 * g8
                    p = p0 + colb // cw2
                    col = rank * cw2 + colb % cw2
                    for h in range(2):
                        for e in range(2):
                            a = jb * st["aj"] + 8 * jj + 2 * t4 + e
                            m = 16 * wq + g8 + 8 * h
                            planes = [acc[cg][m, s * st["aj"] + 8 * jj + 2 * t4 + e]
                                      for s in range(4)]
                            v = _mred(_recombine(planes, k), onem, q, qinv)
                            idx = a * cc + col + h if inverse else (col + h) * cc + a
                            ok = p < polys
                            out[p[ok], idx[ok]] = v[ok]
    return out, q


@pytest.mark.parametrize("logn", [15, 16])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("most", [False, True])
def test_cluster_kernel_emulated(logn, inverse, most):
    """At logN 15-16 the cluster kernel, emulated block by block at the
    least and the most cluster size (groups of 1 to 4 polynomials; with 3
    polynomials a group may be partial), equals the plain version, lazy
    and not, on inputs whose low word sits at 0, q - 1, 2q - 1 and
    2^32 - 1 in turns."""
    import torch

    n = 1 << logn
    q = NTTFriendlyPrimesGenerator(28, 2 * n).next_alternating_primes(1)[0]
    eng = tmxu.NTTMxu(n, [q], [primitive_nth_root(q, 2 * n)], "cpu")
    assert eng.launches_per_call == 1
    size = (eng.max_split if most else eng.min_split)(inverse)
    x = np.random.default_rng(eng.logn).integers(0, 1 << 62, (3, eng.n), dtype=np.uint64)
    for i, low in enumerate((0, q - 1, 2 * q - 1, (1 << 32) - 1)):
        x[:, i::4] = (x[:, i::4] & ~M32) | np.uint64(low)
    got, q = _emulate_cluster(eng, x, inverse, size)
    for lazy in (False, True):
        want = tmxu.four_step_plain(eng, torch.from_numpy(x.view(np.int64))[:, None],
                                    0, inverse, lazy).numpy()[:, 0]
        res = got if lazy else np.where(got >= q, got - q, got)
        np.testing.assert_array_equal(res.view(np.int64), want)
