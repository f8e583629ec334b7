"""Multi-device execution on the CPU: the port's ``parallel/`` on a world
of 4 gloo ranks (``parallel/launch.py``) against the JAX package.

One world runs every program of this file: the coefficient-sharded
NTT / INTT / product at logN 10 (two 45/38-bit primes, as
``tests/test_ntt_sharded.py``) and at logN 8, the dp × limb BGV step
``rescale(mul_relin)`` at the JAX dry run's logN-8 shapes (2 × 2 mesh,
4 limbs, batch 4) and the limb-sharded hoisted rotations [1, 3] on its
8 × 40 + 2 × 45-bit CKKS chain. The JAX side makes the keys and
ciphertexts under one ``jax.jit``; they reach the ranks as integers
through ``interop``. Tolerance: none, every output bit-equal (lazy NTT
outputs against the one-device NTT mod q; against the JAX package's own
sharded NTT bit-equal, lazy too).
"""

import numpy as np
import jax
import pytest
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from lattigo_tpu import rlwe as jrlwe
from lattigo_tpu.parallel.ntt_sp import intt_sharded as j_intt_sharded
from lattigo_tpu.parallel.ntt_sp import ntt_sharded as j_ntt_sharded
from lattigo_tpu.ring.ring import Ring as JRing
from lattigo_tpu.rlwe.elements import Ciphertext as JCiphertext
from lattigo_tpu.schemes import bgv as jbgv, ckks as jckks
from lattigo_tpu.utils.primes import NTTFriendlyPrimesGenerator
from lattigo_tpu_torch.parallel import dryrun, launch

WORLD = 4


def _ring(log_n):
    n = 1 << log_n
    g45 = NTTFriendlyPrimesGenerator(45, 2 * n)
    g38 = NTTFriendlyPrimesGenerator(38, 2 * n)
    return JRing(n, [g45.next_alternating_prime(), g38.next_alternating_prime()])


def _inputs(ring, seed):
    rng = np.random.default_rng(seed)
    q = np.array(ring.moduli, dtype=np.uint64)[None, :, None]
    return [rng.integers(0, 1 << 62, (2, 2, ring.n)).astype(np.uint64) % q
            for _ in range(2)]


def _sp_one_device(ring, a, b):
    def f(a, b):
        fa = ring.ntt(a)
        return dict(ntt=fa, ntt_lazy=ring.ntt(a, lazy=True), intt=ring.intt(fa),
                    intt_lazy=ring.intt(fa, lazy=True),
                    mul=ring.intt(ring.mul_mont(ring.mform(fa), ring.ntt(b))))
    return {k: np.asarray(v) for k, v in jax.jit(f)(a, b).items()}


def _sp_jax_sharded(ring, a):
    mesh = JMesh(np.asarray(jax.devices("cpu")[:WORLD]), axis_names=("sp",))
    sh = NamedSharding(mesh, P(None, None, "sp"))

    def f(x):
        fx = j_ntt_sharded(ring, x, mesh, "sp")
        return dict(ntt=fx, ntt_lazy=j_ntt_sharded(ring, x, mesh, "sp", lazy=True),
                    intt=j_intt_sharded(ring, fx, mesh, "sp"),
                    intt_lazy=j_intt_sharded(ring, fx, mesh, "sp", lazy=True))
    return {k: np.asarray(v) for k, v in jax.jit(f)(jax.device_put(a, sh)).items()}


def _bgv_ref():
    """The JAX dry run's BGV step at logN 8 (4 x 40-bit Q, 45-bit P)."""
    t = NTTFriendlyPrimesGenerator(16, 2 << 8).next_alternating_prime()
    pj = jbgv.Parameters(jbgv.ParametersLiteral(
        log_n=8, log_q=(40,) * 4, log_p=(45,), t=t))
    kg = jrlwe.KeyGenerator(pj)

    def f(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        sk = kg.gen_secret_key(k1)
        rlk = kg.gen_relinearization_key(k2, sk)
        enc = jrlwe.Encryptor(pj, sk)
        ca = enc.encrypt_zero(k3, batch=(4,))
        cb = enc.encrypt_zero(k4, batch=(4,))
        ev = jbgv.Evaluator(pj, jrlwe.EvaluationKeySet(relinearization_key=rlk))
        out = ev.rescale(ev.mul_relin(ca, cb))
        return dict(rlk_q=rlk.gadget.value.q, rlk_p=rlk.gadget.value.p,
                    a=ca.value, b=cb.value, out=out.value)
    arr = {k: np.asarray(v) for k, v in jax.jit(f)(jax.random.PRNGKey(0)).items()}
    return pj, arr


def _hoisted_ref():
    """The JAX dry run's hoisted rotations: CKKS logN 8, 8 x 40 + 2 x 45."""
    pj = jckks.Parameters(jckks.ParametersLiteral(
        log_n=8, log_q=(40,) * 8, log_p=(45,) * 2, log_default_scale=38))
    kg = jrlwe.KeyGenerator(pj)
    rots = [1, 3]
    els = [pj.galois_element(r) for r in rots]

    def f(key):
        k1, k2, k3 = jax.random.split(key, 3)
        sk = kg.gen_secret_key(k1)
        gks = kg.gen_galois_keys(k2, els, sk)
        ev = jckks.Evaluator(pj, jrlwe.EvaluationKeySet(galois_keys=gks))
        ct = jrlwe.Encryptor(pj, sk).encrypt_zero(k3)
        outs = ev.rotate_columns_hoisted(JCiphertext(value=ct.value, is_ntt=True), rots)
        return dict(ct=ct.value, gk={g: (gks[g].gadget.value.q, gks[g].gadget.value.p)
                                     for g in els},
                    outs={r: outs[r].value for r in rots})
    arr = jax.tree_util.tree_map(np.asarray, jax.jit(f)(jax.random.PRNGKey(3)))
    return pj, rots, arr


@pytest.fixture(scope="module")
def world():
    r10, r8 = _ring(10), _ring(8)
    a10, b10 = _inputs(r10, 0)
    a8, b8 = _inputs(r8, 1)
    pb, bgv = _bgv_ref()
    ph, rots, hz = _hoisted_ref()
    programs = [
        ("sp", dict(n=r10.n, moduli=r10.moduli, a=a10, b=b10)),
        ("sp", dict(n=r8.n, moduli=r8.moduli, a=a8, b=b8)),
        ("bgv_step", dict(dp=2, limb=2, literal_json=pb.literal.to_json(),
                          rlk_rows=(bgv["rlk_q"], bgv["rlk_p"]), a=bgv["a"],
                          b=bgv["b"])),
        ("hoisted", dict(limb=2, literal_json=ph.literal.to_json(),
                         galois_rows=hz["gk"], ct=hz["ct"], rots=rots)),
    ]
    ranks = launch.run(dryrun.programs_rank, WORLD, "cpu", programs)
    return dict(
        ranks=ranks, rots=rots, bgv=bgv, hoisted=hz,
        sp={10: (r10, _sp_one_device(r10, a10, b10)),
            8: (r8, _sp_one_device(r8, a8, b8), _sp_jax_sharded(r8, a8))})


@pytest.mark.parametrize("log_n,index", [(10, 0), (8, 1)])
def test_sp_ntt_matches_one_device(world, log_n, index):
    ring, want = world["sp"][log_n][:2]
    got = world["ranks"][0][index]["outputs"]
    q = np.array(ring.moduli, dtype=np.uint64)[None, :, None]
    for k in ("ntt", "intt", "mul"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("ntt_lazy", "intt_lazy"):
        np.testing.assert_array_equal(got[k] % q, want[k] % q, err_msg=k)
    # radix-2 on both sides at these N: the lazy outputs agree bit for bit
    np.testing.assert_array_equal(got["ntt_lazy"], want["ntt_lazy"])
    for r in world["ranks"]:
        assert all(r[index]["checks"].values()), r[index]["checks"]
        assert r[index]["local_shape"] == (2, 2, ring.n // WORLD)


def test_sp_ntt_matches_jax_sharded(world):
    _, _, want = world["sp"][8]
    got = world["ranks"][0][1]["outputs"]
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # log2(4) exchanges a direction, each of a whole local chunk
    chunk = 2 * 2 * (256 // WORLD) * 8
    assert world["ranks"][0][1]["stats"]["swapped"] >= 2 * 2 * chunk


def test_bgv_step_matches_jax(world):
    got = world["ranks"][0][2]
    np.testing.assert_array_equal(got["output"], world["bgv"]["out"])
    assert got["local_in"] == (2, 2, 2, 256)
    assert got["out_shape"] == world["bgv"]["out"].shape
    assert got["step_bytes"]["gathered"] > 0 and got["step_bytes"]["broadcast"] > 0
    # the rescale dropped the last limb on its owner only
    assert [r[2]["local_out"][-2] for r in world["ranks"]] == [2, 1, 2, 1]


def test_hoisted_rotations_match_jax(world):
    got = world["ranks"][0][3]["outputs"]
    for r in world["rots"]:
        np.testing.assert_array_equal(got[r], world["hoisted"]["outs"][r])
    assert world["ranks"][0][3]["local_in"] == (2, 4, 256)


def test_ranks_hold_equal_keys(world):
    for i in (2, 3):
        digests = {r[i]["keys_digest"] for r in world["ranks"]}
        assert len(digests) == 1
