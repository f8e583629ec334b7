"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips where
no CUDA device exists (the CPU tier). On a machine with a card (no JAX
there), run them with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Every comparison is bit for bit (tolerance 0): the kernel and the plain
version compute the same integer function.
"""

import pytest
import torch

from lattigo_tpu_torch.presets import bgv_tpu_params
from lattigo_tpu_torch.ring import ntt_mxu, ntt_pallas, ntt_u64, ntt_u64_mxu
from lattigo_tpu_torch.ring.ring import Ring
from lattigo_tpu_torch.rlwe.params import gen_moduli
from lattigo_tpu_torch.utils.primes import NTTFriendlyPrimesGenerator

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ring(logn, cuda):
    lit = bgv_tpu_params(logn, 438)
    q, p = gen_moduli(logn, 2 << logn, lit.log_q, lit.log_p)
    return Ring(1 << logn, q + p, device=cuda)


_RINGS = {}


def _cached_ring(logn, cuda):
    if logn not in _RINGS:
        _RINGS[logn] = _ring(logn, cuda)
    return _RINGS[logn]


def _residues(ring, batch, seed):
    g = torch.Generator(device=ring.device).manual_seed(seed)
    x = torch.randint(0, 1 << 62, batch + (len(ring.moduli), ring.n),
                      generator=g, device=ring.device)
    return x % ring.q


@pytest.mark.parametrize("logn", [12, 13, 14, 15, 16])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_four_step_kernel_matches_plain(cuda, logn, inverse, lazy):
    """One launch a call at every logN (on a thread-block cluster at logN
    15-16)."""
    ring = _cached_ring(logn, cuda)
    assert ring.ntt_engine == "mxu-cuda"
    eng = ring._mxu
    assert eng.launches_per_call == 1
    x = _residues(ring, (3,), logn)
    before = dict(ntt_mxu.LAUNCHES)
    got = ntt_mxu.four_step_cuda(eng, x, 0, inverse, lazy)
    key = "inverse" if inverse else "forward"
    assert ntt_mxu.LAUNCHES[key] == before[key] + 1
    want = ntt_mxu.four_step_plain(eng, x, 0, inverse, lazy)
    assert torch.equal(got, want)
    assert bool((got < (2 if lazy else 1) * ring.q).all())


@pytest.mark.parametrize("logn", [12, 14, 15, 16])
def test_four_step_kernel_roundtrip_and_offset(cuda, logn):
    ring = _ring(logn, cuda)
    x = _residues(ring, (2,), 100 + logn)
    y = ring.ntt(x)
    assert torch.equal(ring.intt(y), x)
    for i in (1, len(ring.moduli) - 1):
        xi = x[:, i:i + 1].contiguous()
        yi = ring.ntt_single(i, xi)
        assert torch.equal(yi, y[:, i:i + 1])
        assert torch.equal(ring.intt_single(i, yi), xi)


# (polynomials, limbs): 1, 3, 8, 60, 208, 21 and 64 (limb, polynomial) rows,
# each within the 10 limbs left above limb offset 5; 7 and 64 polynomials a
# limb leave a partial group of polynomials at some logN 15-16 cluster size
_GEOMETRY_ROWS = [(1, 1), (1, 3), (2, 4), (6, 10), (26, 8), (7, 3), (64, 1)]
_GEOMETRY = [(logn, inverse, split)
             for logn, rr in ((12, 32), (13, 64), (14, 128))
             for inverse in (False, True)
             for split in ntt_mxu.SPLITS
             if split <= min(8, (128 if inverse else rr) // 16)]
_GEOMETRY += [(logn, inverse, size) for logn in (15, 16) for inverse in (False, True)
              for size in ntt_mxu.CLUSTER_SIZES if size << 14 >= 1 << logn]


@pytest.mark.parametrize("logn, inverse, split", _GEOMETRY)
def test_four_step_kernel_geometry(cuda, logn, inverse, split):
    """Every split (every cluster size at logN 15-16) the kernel has, at
    row counts from 1 to 208, limb offsets 0 and 5, lazy and not, on inputs
    whose low word sits at the edges 0, q-1, 2q-1, 4q-1 and 2^32-1 (the
    kernel reads the low 32 bits and reduces them on entry), bit-equal to
    the plain version."""
    ring = _cached_ring(logn, cuda)
    eng = ring._mxu
    assert split in eng.splits and split <= eng.max_split(inverse)
    g = torch.Generator(device=cuda).manual_seed(400 + logn)
    for polys, limbs in _GEOMETRY_ROWS:
        for limb_lo in (0, 5):
            q = ring.q[limb_lo:limb_lo + limbs]
            x = torch.randint(0, 1 << 62, (polys, limbs, ring.n),
                              generator=g, device=cuda)
            for i, low in enumerate((0 * q, q - 1, 2 * q - 1, 4 * q - 1,
                                     torch.full_like(q, (1 << 32) - 1))):
                hi = x[..., i::5] & ~((1 << 32) - 1)
                x[..., i::5] = hi | low.expand_as(x[..., i::5])
            for lazy in (False, True):
                got = ntt_mxu.four_step_cuda(eng, x, limb_lo, inverse, lazy,
                                             split=split)
                want = ntt_mxu.four_step_plain(eng, x, limb_lo, inverse, lazy)
                assert torch.equal(got, want), (polys, limbs, limb_lo, lazy)


def _extreme_input(eng, limb, inverse):
    """One polynomial of limb ``limb`` whose step-1 plane sums reach toward
    their bound ±128·128·K: the weight row of step 1 with the
    largest sum of |digit| is matched, digit by digit, by the three low
    digits of one column of the input (forward: column j2 = 0, inverse:
    row t1 = 0) at 127 or -128 with the weight's sign, and by the opposite
    signs in the next column (j2 = 1, or t1 = 1); every other coefficient
    uniform. A value is placed so that the kernel's entry reduction (a
    Montgomery multiply by 2^32 mod q) gives it back: the first low word
    x = v + j·q (j < 16) that reduces to v, over top digits 1..15."""
    rr, cc = eng.rr, eng.cc
    a = cc if inverse else rr                          # step 1's contraction
    w = (eng.w1i_t if inverse else eng.w1f)[limb].to(torch.int64)
    row = int(w.abs().sum(dim=1).argmax())
    pos = w[row].reshape(4, a) > 0                     # [i, k]
    q = int(eng.consts[limb, 0])
    qinv, onem = (int(eng.consts[limb, c]) & 0xFFFFFFFF for c in (1, 4))
    dev = w.device
    x = torch.randint(0, q, (rr, cc), device=dev)
    for col, sign in ((0, 1), (1, -1)):
        d = torch.where(pos == (sign > 0), 127, -128)[:3]
        low = d[0] + 256 * d[1] + 65536 * d[2]         # [a]
        top = torch.arange(1, 16, device=dev)[:, None, None]
        j = torch.arange(16, device=dev)[None, :, None]
        v = low + (top << 24)                           # [15, 1, a]
        cand = v + j * q                                # [15, 16, a]
        ok = (v < q) & (cand < (1 << 32)) & (
            ntt_mxu._mred_lazy32(cand, torch.tensor(onem, device=dev),
                                 torch.tensor(q, device=dev),
                                 torch.tensor(qinv, device=dev)) == v)
        flat = ok.reshape(-1, a)
        assert bool(flat.any(dim=0).all()), "no low word reduces to the digits"
        first = flat.to(torch.int64).argmax(dim=0)
        col_x = cand.reshape(-1, a).gather(0, first[None])[0]
        if inverse:
            x[col] = col_x
        else:
            x[:, col] = col_x
    return x.reshape(1, 1, rr * cc)


@pytest.mark.parametrize("logn", [15, 16])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_kernel_extreme_plane_sums(cuda, logn, inverse):
    """Plane sums of step 1 driven past a quarter of their bound 128·128·4A
    (2^24 where step 1 contracts over A = 256: forward at logN 15-16,
    inverse at 16), lazy and not, at a limb offset: the kernel stays
    bit-equal to plain."""
    ring = _cached_ring(logn, cuda)
    eng = ring._mxu
    limb = 3
    x = _extreme_input(eng, limb, inverse)
    # the plane sums the input makes, as the plain version forms them
    v = ntt_mxu._mred_lazy32(x.reshape(eng.rr, eng.cc) & 0xFFFFFFFF,
                             eng.consts[limb, 4].to(torch.int64) & 0xFFFFFFFF,
                             eng.consts[limb, 0].to(torch.int64),
                             eng.consts[limb, 1].to(torch.int64) & 0xFFFFFFFF)
    planes = torch.cat(ntt_mxu._digit_planes(v.T if not inverse else v), dim=-1)
    w = (eng.w1i_t if inverse else eng.w1f)[limb].to(torch.float64)
    sums = w @ planes.T                                 # [(s, a), columns]
    bound = 128 * 128 * w.shape[0]
    assert float(sums.max()) > bound / 4 and float(sums.min()) < -bound / 4
    for lazy in (False, True):
        got = ntt_mxu.four_step_cuda(eng, x, limb, inverse, lazy)
        want = ntt_mxu.four_step_plain(eng, x, limb, inverse, lazy)
        assert torch.equal(got, want), lazy


def test_four_step_kernel_rejects_bad_input(cuda):
    ring = _ring(12, cuda)
    eng = ring._mxu
    x = _residues(ring, (2,), 1)
    with pytest.raises(TypeError):
        ntt_mxu.four_step_cuda(eng, x.to(torch.int32), 0, False, False)
    with pytest.raises(ValueError):
        ntt_mxu.four_step_cuda(eng, x.transpose(0, 1), 0, False, False)
    with pytest.raises(ValueError):
        ntt_mxu.four_step_cuda(eng, x[..., : ring.n // 2].contiguous(), 0,
                               False, False)
    with pytest.raises(ValueError):
        ntt_mxu.four_step_cuda(eng, x, 1, False, False)
    for split in (3, 4):                 # 4: forward at logN 12 allows 2
        with pytest.raises(ValueError):
            ntt_mxu.four_step_cuda(eng, x, 0, False, False, split=split)


def _u32_ring(logn, cuda, limbs=3):
    """29-bit alternating primes: some >= 2^29, so the ring takes u32."""
    n = 1 << logn
    moduli = NTTFriendlyPrimesGenerator(29, 2 * n).next_alternating_primes(limbs)
    return Ring(n, moduli, device=cuda)


@pytest.mark.parametrize("logn", range(9, 16))
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_u32_kernel_matches_plain(cuda, logn, inverse, lazy):
    ring = _u32_ring(logn, cuda)
    assert ring.ntt_engine == "u32-cuda"
    eng = ring._u32
    x = _residues(ring, (3,), logn)
    if inverse:                  # the inverse takes the forward's lazy range
        x = ntt_pallas.u32_plain(eng, x, 0, False, True)
    before = dict(ntt_pallas.LAUNCHES)
    got = ntt_pallas.u32_cuda(eng, x, 0, inverse, lazy)
    key = "inverse" if inverse else "forward"
    assert ntt_pallas.LAUNCHES[key] == before[key] + 1
    want = ntt_pallas.u32_plain(eng, x, 0, inverse, lazy)
    assert torch.equal(got, want)
    bound = (2 if inverse else 4) if lazy else 1
    assert bool((got < bound * ring.q).all())


@pytest.mark.parametrize("logn", range(9, 16))
def test_u32_kernel_roundtrip_and_offset(cuda, logn):
    ring = _u32_ring(logn, cuda)
    x = _residues(ring, (2,), 200 + logn)
    y = ring.ntt(x)
    assert torch.equal(ring.intt(y), x)
    for i in (1, len(ring.moduli) - 1):
        xi = x[:, i:i + 1].contiguous()
        yi = ring.ntt_single(i, xi)
        assert torch.equal(yi, y[:, i:i + 1])
        assert torch.equal(yi, ntt_pallas.u32_plain(ring._u32, xi, i, False, False))
        xb = ring.intt_single(i, yi)
        assert torch.equal(xb, ntt_pallas.u32_plain(ring._u32, yi, i, True, False))
        assert torch.equal(xb, xi)


@pytest.mark.parametrize("logn, batch, limbs", [
    *[(logn, 1, rows) for logn in (9, 10, 14) for rows in (1, 2, 3, 5, 17)],
    # one, two and four blocks per row at every chunk size the kernel has
    (11, 5, 1), (12, 5, 1), (12, 100, 2), (13, 5, 1), (13, 50, 2),
    (13, 100, 2), (14, 50, 2), (15, 3, 1)])
@pytest.mark.parametrize("inverse", [False, True])
def test_u32_kernel_geometry(cuda, logn, batch, limbs, inverse):
    """Row counts around the block packing and the split of a row over a
    cluster, on inputs up to the top of each contract: the forward takes
    [0, 4q), the inverse [0, 2q)."""
    ring = _u32_ring(logn, cuda, limbs)
    eng = ring._u32
    top = (2 if inverse else 4) * ring.q
    g = torch.Generator(device=cuda).manual_seed(300 + logn)
    x = torch.randint(0, 1 << 62, (batch, limbs, ring.n), generator=g,
                      device=cuda) % top
    x[..., ::7] = (top - 1).expand_as(x[..., ::7])
    for lazy in (False, True):
        got = ntt_pallas.u32_cuda(eng, x, 0, inverse, lazy)
        assert torch.equal(got, ntt_pallas.u32_plain(eng, x, 0, inverse, lazy))


def test_u32_kernel_rejects_bad_input(cuda):
    ring = _u32_ring(10, cuda)
    eng = ring._u32
    x = _residues(ring, (2,), 1)
    with pytest.raises(TypeError):
        ntt_pallas.u32_cuda(eng, x.to(torch.int32), 0, False, False)
    with pytest.raises(ValueError):
        ntt_pallas.u32_cuda(eng, x.transpose(0, 1), 0, False, False)
    with pytest.raises(ValueError):
        ntt_pallas.u32_cuda(eng, x[..., : ring.n // 2].contiguous(), 0,
                            False, False)
    with pytest.raises(ValueError):
        ntt_pallas.u32_cuda(eng, x, 1, False, False)
    with pytest.raises(ValueError):                 # not 16-byte aligned
        ntt_pallas.u32_cuda(eng, x.reshape(-1)[1:1 + ring.n].view(1, ring.n),
                            0, False, False)
    psi = ring.subrings[0].psi
    with pytest.raises(ValueError):                 # N < 512
        ntt_pallas.NTTPallas(256, ring.moduli[:1], [psi], cuda)
    big = NTTFriendlyPrimesGenerator(31, 2048).next_alternating_prime()
    with pytest.raises(ValueError):                 # q >= 2^30
        ntt_pallas.NTTPallas(1024, [big], [psi], cuda)


# the u64 kernel's chains: PN16QP1761's widths, and a mixed chain whose
# 25-bit limb still takes the 64-bit Montgomery route
_U64_CHAINS = {"45/55/56": (45, 55, 56), "25/50/61": (25, 50, 61)}
_U64_RINGS = {}


def _u64_ring(logn, chain, cuda):
    key = (logn, chain)
    if key not in _U64_RINGS:
        n = 1 << logn
        bits = _U64_CHAINS[chain]
        gens = {b: NTTFriendlyPrimesGenerator(b, 2 * n) for b in set(bits)}
        _U64_RINGS[key] = Ring(n, [gens[b].next_downstream_prime() for b in bits],
                               device=cuda)
    return _U64_RINGS[key]


def _u64_inputs(ring, batch, seed):
    """Uniform in [0, 2q), every 7th coefficient at 2q - 1 (the top of the
    contract)."""
    q2 = 2 * ring.q
    g = torch.Generator(device=ring.device).manual_seed(seed)
    x = torch.randint(0, 1 << 62, batch + (q2.shape[0], ring.n), generator=g,
                      device=ring.device) % q2
    x[..., ::7] = (q2 - 1).expand_as(x[..., ::7])
    return x


@pytest.mark.parametrize("logn", [15, 16])
@pytest.mark.parametrize("chain", list(_U64_CHAINS))
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_u64_kernel_matches_plain_and_mxu64(cuda, logn, chain, inverse, lazy):
    """Two launches a call; bit-equal to the plain version; non-lazy
    bit-equal to the u64 four-step engine on the card, lazy equal mod q and
    in [0, 2q)."""
    ring = _u64_ring(logn, chain, cuda)
    assert ring.ntt_engine == "u64-cuda" and ring._mxu64 is None
    eng = ring._u64
    x = _u64_inputs(ring, (3,), logn + 10 * inverse)
    key = "inverse" if inverse else "forward"
    before = dict(ntt_u64.LAUNCHES)
    got = ntt_u64.u64_cuda(eng, x, 0, inverse, lazy)
    assert ntt_u64.LAUNCHES[key] == before[key] + ntt_u64.LAUNCHES_PER_CALL == before[key] + 2
    assert torch.equal(got, ntt_u64.u64_plain(eng, x, 0, inverse, lazy))
    q = ring.q
    assert bool(((got >= 0) & (got < (2 if lazy else 1) * q)).all())
    mxu64 = ntt_u64_mxu.NTTMxu64(ring.n, ring.moduli, [s.psi for s in ring.subrings], cuda)
    want = (mxu64.intt if inverse else mxu64.ntt)(x, lazy=lazy)
    if lazy:
        assert torch.equal(got % q, want % q)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("logn", [15, 16])
@pytest.mark.parametrize("chain", list(_U64_CHAINS))
def test_u64_kernel_roundtrip_and_offset(cuda, logn, chain):
    """NTT then INTT is the identity; ``*_single`` at limbs 1 and 2 (lazy and
    not) equals the whole call's limb and the plain version at that offset;
    row counts 1 to 2 x 3 limbs."""
    ring = _u64_ring(logn, chain, cuda)
    eng = ring._u64
    x = _u64_inputs(ring, (2,), 500 + logn)
    for lazy in (False, True):
        y = ring.ntt(x, lazy=lazy)
        assert torch.equal(ring.intt(y), x % ring.q)
    y = ring.ntt(x)
    for i in (1, 2):
        xi = x[:, i:i + 1].contiguous()
        for lazy in (False, True):
            yi = ring.ntt_single(i, xi, lazy=lazy)
            assert torch.equal(yi, ntt_u64.u64_plain(eng, xi, i, False, lazy))
            xb = ring.intt_single(i, yi, lazy=lazy)
            assert torch.equal(xb, ntt_u64.u64_plain(eng, yi, i, True, lazy))
        assert torch.equal(ring.ntt_single(i, xi), y[:, i:i + 1])
        one = xi[:1]
        assert torch.equal(ring.intt_single(i, ring.ntt_single(i, one)), one % ring.q[i])
    two = x[:, 1:].contiguous()                      # limbs 1-2 from offset 1
    assert torch.equal(ntt_u64.u64_cuda(eng, two, 1, False, False), y[:, 1:])


def test_u64_kernel_rejects_bad_input(cuda):
    ring = _u64_ring(15, "45/55/56", cuda)
    eng = ring._u64
    x = _u64_inputs(ring, (2,), 1)
    with pytest.raises(TypeError):
        ntt_u64.u64_cuda(eng, x.to(torch.int32), 0, False, False)
    with pytest.raises(ValueError):                 # not contiguous
        ntt_u64.u64_cuda(eng, x.transpose(0, 1), 0, False, False)
    with pytest.raises(ValueError):                 # N
        ntt_u64.u64_cuda(eng, x[..., : ring.n // 2].contiguous(), 0, False, False)
    with pytest.raises(ValueError):                 # limbs past the table
        ntt_u64.u64_cuda(eng, x, 1, False, False)
    with pytest.raises(ValueError):                 # device
        ntt_u64.u64_cuda(eng, x.cpu(), 0, False, False)
    with pytest.raises(ValueError):                 # N the kernel has not
        ntt_u64.NTTU64(1 << 14, ring.q, ring.qinv, ring.ninv, ring.roots, ring.iroots)


def test_four_step_kernel_on_the_ckks_step(cuda, monkeypatch):
    """The CKKS slice's step at logN 12 on the card, rescale(evaluate(
    rescale(mul_relin(a, b)))) with 16 diagonals (n1 = 4), on a batch of 2:
    every distinct four-step call it makes is held against the plain
    version on its own input, and the slots decode to M·(a∘b)."""
    import numpy as np
    from lattigo_tpu_torch import rlwe
    from lattigo_tpu_torch.circuits import lintrans
    from lattigo_tpu_torch.presets import ckks_tpu_params
    from lattigo_tpu_torch.schemes import ckks

    params = ckks.Parameters(ckks_tpu_params(12, 218), device=cuda)
    assert params.ring_q.ntt_engine == params.ring_p.ntt_engine == "mxu-cuda"
    level = params.max_level - 1
    gen = torch.Generator(device=cuda).manual_seed(13)
    kg = rlwe.KeyGenerator(params)
    sk = kg.gen_secret_key(gen)
    enc = ckks.Encoder(params)
    rng = np.random.default_rng(13)
    slots = params.max_slots
    a, b = (rng.uniform(-1, 1, (2, slots)) + 1j * rng.uniform(-1, 1, (2, slots))
            for _ in range(2))
    diags = {k: rng.uniform(-1 / 16, 1 / 16, slots)
             + 1j * rng.uniform(-1 / 16, 1 / 16, slots) for k in range(16)}
    lt = lintrans.encode_linear_transformation(
        params, diags, lintrans.ckks_diag_encoder(params, enc, params.q_moduli[level]),
        level_q=level, scale=params.q_moduli[level], slots=slots)
    els = lt.galois_elements(params)
    ev = ckks.Evaluator(params, rlwe.EvaluationKeySet(
        kg.gen_relinearization_key(gen, sk),
        kg.gen_galois_keys(gen, els, sk, levels={g: level for g in els})))
    encryptor = rlwe.Encryptor(params, sk)
    ca = encryptor.encrypt(gen, enc.encode(a), batch=(2,))
    cb = encryptor.encrypt(gen, enc.encode(b), batch=(2,))

    calls = {}
    launch = ntt_mxu.four_step_cuda

    def recording(eng, x, limb_lo, inverse, lazy, **kw):
        calls.setdefault((tuple(x.shape), limb_lo, inverse, lazy),
                         (eng, x.clone(), limb_lo, inverse, lazy))
        return launch(eng, x, limb_lo, inverse, lazy, **kw)

    monkeypatch.setattr(ntt_mxu, "four_step_cuda", recording)
    out = ev.rescale(lintrans.LinTransEvaluator(ev).evaluate(
        ev.rescale(ev.mul_relin(ca, cb)), lt))
    monkeypatch.undo()
    assert out.level == level - 1
    assert {inv for _, _, inv, _ in calls} == {False, True}
    for eng, x, limb_lo, inverse, lazy in calls.values():
        assert torch.equal(launch(eng, x, limb_lo, inverse, lazy),
                           ntt_mxu.four_step_plain(eng, x, limb_lo, inverse, lazy))
    want = np.zeros_like(a)
    for k, d in diags.items():
        want += d * np.roll(a * b, -k, axis=-1)
    got = enc.decode(rlwe.Decryptor(params, sk).decrypt(out))
    ckks.verify_test_vectors(want, got, 12.0)


def test_four_step_kernel_on_the_multiparty_path(cuda, monkeypatch):
    """The multiparty path at logN 14 on the card, bgv_tpu_params(14, 438)
    with 3 parties: collective public key, two-round relinearization key,
    an encryption under the collective key, mul_relin + rescale and the
    collective decryption (CKS to 0): every distinct four-step call it
    makes is held against the plain version on its own input, and the
    slots decode to a*b mod T."""
    import numpy as np
    from lattigo_tpu_torch import multiparty as mp, rlwe
    from lattigo_tpu_torch.presets import bgv_tpu_params
    from lattigo_tpu_torch.schemes import bgv

    params = bgv.Parameters(bgv_tpu_params(14, 438), device=cuda)
    assert {params.ring_q.ntt_engine, params.ring_p.ntt_engine,
            params.ring_t.ntt_engine} == {"mxu-cuda"}
    gens = [torch.Generator(device=cuda).manual_seed(20 + i) for i in range(3)]
    kg = rlwe.KeyGenerator(params)
    enc = bgv.Encoder(params)
    rng = np.random.default_rng(20)
    a, b = (rng.integers(0, params.t, (2, params.n)) for _ in range(2))

    def agg(proto, shares):
        out = shares[0]
        for s in shares[1:]:
            out = proto.aggregate_shares(out, s)
        return out

    calls = {}
    launch = ntt_mxu.four_step_cuda

    def recording(eng, x, limb_lo, inverse, lazy, **kw):
        calls.setdefault((id(eng), tuple(x.shape), limb_lo, inverse, lazy),
                         (eng, x.clone(), limb_lo, inverse, lazy))
        return launch(eng, x, limb_lo, inverse, lazy, **kw)

    monkeypatch.setattr(ntt_mxu, "four_step_cuda", recording)
    sks = [kg.gen_secret_key(g) for g in gens]
    cpk_p = mp.PublicKeyGenProtocol(params)
    crp = cpk_p.sample_crp(b"card-cpk")
    cpk = cpk_p.finalize(agg(cpk_p, [cpk_p.gen_share(g, s, crp)
                                     for g, s in zip(gens, sks)]), crp)
    rlk_p = mp.RelinearizationKeyGenProtocol(params)
    crps = rlk_p.sample_crp(b"card-rlk")
    eph = [rlk_p.gen_ephemeral(g) for g in gens]
    agg1 = agg(rlk_p, [rlk_p.gen_share_round1(g, s, u, crps)
                       for g, s, u in zip(gens, sks, eph)])
    agg2 = agg(rlk_p, [rlk_p.gen_share_round2(g, s, u, agg1)
                       for g, s, u in zip(gens, sks, eph)])
    ev = bgv.Evaluator(params, rlwe.EvaluationKeySet(rlk_p.finalize(agg1, agg2)))
    encryptor = rlwe.Encryptor(params, cpk)
    out = ev.rescale(ev.mul_relin(encryptor.encrypt(gens[0], enc.encode(a), batch=(2,)),
                                  encryptor.encrypt(gens[0], enc.encode(b), batch=(2,))))
    cks = mp.KeySwitchProtocol(params)
    res = cks.key_switch(out, agg(cks, [cks.gen_share(g, s, None, out)
                                        for g, s in zip(gens, sks)]))
    got = enc.decode(rlwe.Plaintext(value=res.value[..., 0, :, :], scale=res.scale))
    monkeypatch.undo()
    assert {inv for _, _, _, inv, _ in calls} == {False, True}
    for eng, x, limb_lo, inverse, lazy in calls.values():
        assert torch.equal(launch(eng, x, limb_lo, inverse, lazy),
                           ntt_mxu.four_step_plain(eng, x, limb_lo, inverse, lazy))
    np.testing.assert_array_equal(got, a * b % params.t)
