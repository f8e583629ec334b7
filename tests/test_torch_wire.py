"""Port parity for Lattigo's wire format (``utils/lattigo_wire.py``).

The primitives, the fixed-width metadata and Go's float text, case for
case with ``tests/test_lattigo_wire.py``, must give the JAX package's
bytes. Then, on the port's keys and ciphertexts at that file's CKKS
parameters (logN 9) and a BGV set beside them: for a secret key, a public
key, a ciphertext, a BGV and a CKKS plaintext, an RNS and a base-2
relinearization key, an evaluation key and a Galois key, the bytes the port
writes equal the bytes the JAX package writes for the same object (built
from the port's arrays), each package reads the other's bytes back to an
equal object, and what the port reads decrypts (or key-switches) exactly
as before. Tolerance 0 throughout; the JAX side is numpy only.
"""

import struct
from fractions import Fraction

import numpy as np
import pytest
import torch

from lattigo_tpu.ring.ringqp import QPPoly as JQPPoly
from lattigo_tpu.rlwe import elements as jel, keys as jkeys
from lattigo_tpu.utils import lattigo_wire as jwire
from lattigo_tpu_torch import interop, rlwe
from lattigo_tpu_torch.schemes import bgv, ckks
from lattigo_tpu_torch.utils import lattigo_wire as twire

CKKS_LIT = dict(log_n=9, log_q=(45, 38, 38), log_p=(45,), log_default_scale=38)
BASE2 = 13


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- primitives ------------------------------------------------------------------

def test_u64_vector_layout():
    v = np.arange(5, dtype=np.uint64)
    b = twire.write_u64_vector(v)
    assert b == jwire.write_u64_vector(v)
    assert len(b) == 8 + 5 * 8 and struct.unpack_from("<Q", b, 0)[0] == 5
    out, off = twire.read_u64_vector(memoryview(b), 0)
    assert off == len(b) and np.array_equal(out, v)


@pytest.mark.parametrize("shape", [(3, 16), (1, 8), (0, 0)])
def test_poly_layout_and_roundtrip(shape):
    c = np.random.default_rng(0).integers(0, 1 << 60, shape, dtype=np.uint64)
    b = twire.write_poly(c)
    assert b == jwire.write_poly(c)
    assert len(b) == 8 + shape[0] * (8 + shape[1] * 8)
    for read in (twire.read_poly, jwire.read_poly):
        out, off = read(memoryview(b), 0)
        assert off == len(b) and np.array_equal(out, c.reshape(out.shape))


def test_poly_rows_of_unequal_length():
    """A matrix whose rows differ in length is no polynomial: both
    packages refuse it."""
    rows = [np.arange(3, dtype=np.uint64), np.arange(5, dtype=np.uint64)]
    b = struct.pack("<Q", 2) + b"".join(jwire.write_u64_vector(r) for r in rows)
    for read in (twire.read_poly, jwire.read_poly):
        with pytest.raises(ValueError):
            read(memoryview(b), 0)


@pytest.mark.parametrize("scale", [2**45, Fraction(2**90, 1125899906826241), 65537, 1])
def test_metadata_fixed_width_and_roundtrip(scale):
    kw = dict(scale=scale, scale_mod=65537, log_dimensions=(1, 13),
              is_batched=True, is_ntt=True, is_montgomery=False)
    b = twire.write_metadata(**kw)
    assert b == jwire.write_metadata(**kw)
    assert len(b) == twire.METADATA_SIZE == jwire.METADATA_SIZE == 277
    got, off = twire.read_metadata(memoryview(b), 0)
    want, _ = jwire.read_metadata(memoryview(b), 0)
    assert off == 277 and got == want
    assert got["scale_mod"] == 65537 and got["log_dimensions"] == (1, 13)
    assert got["is_batched"] and got["is_ntt"] and not got["is_montgomery"]


@pytest.mark.parametrize("x, want", [
    (2**40, "1.099511627776000000000000000000000000000e+12"),
    (1, "1.000000000000000000000000000000000000000e+00"),
    (0, "0.000000000000000000000000000000000000000e+00"),
    (65537, "6.553700000000000000000000000000000000000e+04"),
    (Fraction(2**56, 268582913), jwire._go_float_text(Fraction(2**56, 268582913))),
])
def test_go_float_text_format(x, want):
    got = twire._go_float_text(x)
    assert got == want == jwire._go_float_text(x) and len(got) == 45


# -- objects ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def ctx():
    params = ckks.Parameters(ckks.ParametersLiteral(**CKKS_LIT), device="cpu")
    bparams = bgv.Parameters(bgv.ParametersLiteral(
        log_n=9, log_q=(45, 38), log_p=(50,), t=65537), device="cpu")
    gen = torch.Generator().manual_seed(42)
    kg = rlwe.KeyGenerator(params)
    sk, sk2 = kg.gen_secret_key(gen), kg.gen_secret_key(gen)
    g1 = params.galois_element(1)
    enc = ckks.Encoder(params)
    rng = np.random.default_rng(1)
    v = rng.uniform(-1, 1, params.max_slots) + 1j * rng.uniform(-1, 1, params.max_slots)
    pt = enc.encode(v)
    bsk = rlwe.KeyGenerator(bparams).gen_secret_key(gen)
    m = rng.integers(0, bparams.t, bparams.n)
    bpt = bgv.Encoder(bparams).encode(m)
    objs = {
        "sk": sk,
        "pk": kg.gen_public_key(gen, sk),
        "ct": rlwe.Encryptor(params, sk).encrypt(gen, pt),
        "pt_ckks": pt,
        "pt_bgv": bpt,
        "ct_bgv": rlwe.Encryptor(bparams, bsk).encrypt(gen, bpt),
        "rlk": kg.gen_relinearization_key(gen, sk),
        "rlk_base2": kg.gen_relinearization_key(gen, sk, base2=BASE2),
        "evk": kg.gen_evaluation_key(gen, sk, sk2),
        "gk": kg.gen_galois_keys(gen, [g1], sk)[g1],
    }
    return dict(params=params, bparams=bparams, sk=sk, sk2=sk2, bsk=bsk, v=v, m=m,
                objs=objs)


def _np(t):
    return None if t is None else interop.to_numpy(t)


def _jgadget(g):
    return jkeys.GadgetCiphertext(JQPPoly(_np(g.value.q), _np(g.value.p)), base2=g.base2)


def to_jax(kind, obj):
    """The JAX package's object holding the port object's arrays."""
    if kind == "sk":
        return jkeys.SecretKey(JQPPoly(_np(obj.value.q), _np(obj.value.p)))
    if kind == "pk":
        return jkeys.PublicKey(JQPPoly(_np(obj.value.q), _np(obj.value.p)))
    if kind.startswith("ct"):
        return jel.Ciphertext(_np(obj.value), is_ntt=obj.is_ntt, scale=obj.scale)
    if kind.startswith("pt"):
        return jel.Plaintext(_np(obj.value), is_ntt=obj.is_ntt, scale=obj.scale)
    if kind.startswith("rlk"):
        return jkeys.RelinearizationKey(_jgadget(obj.gadget))
    if kind == "evk":
        return jkeys.EvaluationKey(_jgadget(obj.gadget))
    return jkeys.GaloisKey(_jgadget(obj.gadget), obj.gal_el)


def writers(kind, params):
    """(port writer, JAX writer, port reader, JAX reader) of one kind."""
    q_moduli = params.q_moduli
    if kind == "sk":
        return (twire.secret_key_to_bytes, jwire.secret_key_to_bytes,
                twire.secret_key_from_bytes, jwire.secret_key_from_bytes)
    if kind == "pk":
        return (twire.public_key_to_bytes, jwire.public_key_to_bytes,
                twire.public_key_from_bytes, jwire.public_key_from_bytes)
    if kind.startswith(("ct", "pt")):
        dims = (1, params.log_n - 1) if kind.endswith("bgv") else (0, params.log_n - 1)
        return (lambda o: twire.ciphertext_to_bytes(o, log_dimensions=dims),
                lambda o: jwire.ciphertext_to_bytes(o, log_dimensions=dims),
                twire.ciphertext_from_bytes, jwire.ciphertext_from_bytes)
    if kind.startswith("rlk"):
        return (lambda o: twire.relinearization_key_to_bytes(o, q_moduli),
                lambda o: jwire.relinearization_key_to_bytes(o, q_moduli),
                twire.relinearization_key_from_bytes,
                jwire.relinearization_key_from_bytes)
    if kind == "evk":
        return (twire.evaluation_key_to_bytes, jwire.evaluation_key_to_bytes,
                twire.evaluation_key_from_bytes, jwire.evaluation_key_from_bytes)
    return (lambda o: twire.galois_key_to_bytes(o, params.nth_root),
            lambda o: jwire.galois_key_to_bytes(o, params.nth_root),
            twire.galois_key_from_bytes, jwire.galois_key_from_bytes)


def arrays(obj):
    """Every residue array of a port or JAX object (as uint64) and its
    metadata, for equality across packages."""
    if hasattr(obj, "gadget"):
        g = obj.gadget
        return ([np.asarray(_np(x) if isinstance(x, torch.Tensor) else x)
                 for x in (g.value.q, g.value.p) if x is not None],
                (g.base2, getattr(obj, "gal_el", None)))
    if hasattr(obj, "is_ntt"):
        v = obj.value
        return ([np.asarray(_np(v) if isinstance(v, torch.Tensor) else v)],
                (obj.is_ntt, obj.is_montgomery, obj.scale))
    return ([np.asarray(_np(x) if isinstance(x, torch.Tensor) else x)
             for x in (obj.value.q, obj.value.p) if x is not None], None)


def assert_equal_objects(a, b):
    (xa, ma), (xb, mb) = arrays(a), arrays(b)
    assert ma == mb and len(xa) == len(xb)
    for u, v in zip(xa, xb):
        np.testing.assert_array_equal(u, v)


def check_use(kind, obj, c):
    """The object read back by the port works as the original did."""
    params, bparams = c["params"], c["bparams"]
    enc = ckks.Encoder(params)
    dec = rlwe.Decryptor(params, c["sk"])
    gen = torch.Generator().manual_seed(7)
    if kind in ("sk", "pk"):
        encr = rlwe.Encryptor(params, obj)
        out = enc.decode(dec.decrypt(encr.encrypt(gen, enc.encode(c["v"]))))
        assert np.abs(out - c["v"]).max() < 1e-6
    elif kind == "ct":
        assert np.abs(enc.decode(dec.decrypt(obj)) - c["v"]).max() < 1e-6
    elif kind == "pt_ckks":
        assert np.abs(enc.decode(obj) - c["v"]).max() < 1e-6
    elif kind == "pt_bgv":
        assert np.array_equal(bgv.Encoder(bparams).decode(obj), c["m"])
    elif kind == "ct_bgv":
        pt = rlwe.Decryptor(bparams, c["bsk"]).decrypt(obj)
        assert np.array_equal(bgv.Encoder(bparams).decode(pt), c["m"])
    elif kind.startswith("rlk"):
        ev = ckks.Evaluator(params, rlwe.EvaluationKeySet(relinearization_key=obj))
        ct = c["objs"]["ct"]
        out = enc.decode(dec.decrypt(ev.rescale(ev.mul_relin(ct, ct))))
        assert np.abs(out - c["v"] ** 2).max() < 1e-4
    elif kind == "evk":
        sw = rlwe.Evaluator(params).apply_evaluation_key(c["objs"]["ct"], obj)
        out = enc.decode(rlwe.Decryptor(params, c["sk2"]).decrypt(sw))
        assert np.abs(out - c["v"]).max() < 1e-5
    else:
        ev = ckks.Evaluator(params, rlwe.EvaluationKeySet(galois_keys={obj.gal_el: obj}))
        out = enc.decode(dec.decrypt(ev.rotate(c["objs"]["ct"], 1)))
        assert np.abs(out - np.roll(c["v"], -1)).max() < 1e-5


KINDS = ["sk", "pk", "ct", "pt_bgv", "pt_ckks", "ct_bgv", "rlk", "rlk_base2",
         "evk", "gk"]


@pytest.mark.parametrize("kind", KINDS)
def test_object_bytes_equal_and_read_across(ctx, kind):
    obj = ctx["objs"][kind]
    params = ctx["bparams"] if kind.endswith("bgv") else ctx["params"]
    t_write, j_write, t_read, j_read = writers(kind, params)
    data = t_write(obj)
    assert data == j_write(to_jax(kind, obj))
    back = t_read(data, device="cpu")
    assert_equal_objects(back, obj)
    assert_equal_objects(j_read(data), obj)
    assert t_write(back) == data
    check_use(kind, back, ctx)


def test_sizes_follow_lattigo_layout(ctx):
    """A degree-1 ciphertext: flag + metadata + count + 2 polys of
    (#limbs + limbs × (length + N words)); the base-2 key drops each limb's
    rows past its digit count (45-bit limb: 4 digits of 13 bits, 38-bit
    limbs: 3), which the port keeps as zero rows."""
    params = ctx["params"]
    n, lq = params.n, len(params.q_moduli)
    ct = twire.ciphertext_to_bytes(ctx["objs"]["ct"])
    assert len(ct) == 1 + 277 + 8 + 2 * (8 + lq * 8 * (n + 1))
    rlk = ctx["objs"]["rlk_base2"]
    digits = twire._base2_digit_counts(params.q_moduli, BASE2)
    assert digits == [4, 3, 3] and rlk.gadget.value.q.shape[0] == lq * 4
    poly_qp = (8 + lq * 8 * (n + 1)) + (8 + 8 * (n + 1))
    want = 16 + sum(8 + d * (8 + 2 * poly_qp) for d in digits)
    assert len(twire.relinearization_key_to_bytes(rlk, params.q_moduli)) == want
    q = rlk.gadget.value.q
    assert not q[[4 * i + 3 for i in (1, 2)]].any() and q[[3]].any()
    with pytest.raises(ValueError):
        twire.relinearization_key_to_bytes(rlk)


# -- the JAX package's precision on chip_smoke.py phase 10c ----------------------------

def reference_phase10c_bits(log_n: int = 14) -> tuple:
    """The JAX package's precision (min, avg bits) on chip_smoke.py phase
    10c's CKKS request, rotate(rescale(mul_relin(a, b)), 1) at
    ``ckks_tpu_params(log_n, 438)``, on that phase's inputs (its own keys).
    The wire does not enter: phase 10c checks that the bytes change no
    decoded slot. Everything but the host decode runs under one
    ``jax.jit``."""
    import sys
    import time
    from pathlib import Path

    import jax

    from lattigo_tpu import presets as jpresets, rlwe as jrlwe
    from lattigo_tpu.schemes import ckks as jckks
    from lattigo_tpu.schemes.ckks.precision import get_precision_stats

    here = Path(__file__).resolve().parent
    sys.path[:0] = [str(here.parent), str(here)]
    import chip_smoke as cs
    from test_torch_ci_ring import FAST_COMPILE, jit_gadget_products

    t0 = time.time()
    p = jckks.Parameters(jpresets.ckks_tpu_params(log_n, cs.LOG_QP))
    x = cs.wire_inputs(1 << log_n, 65537, p.max_slots)
    enc, rot = jckks.Encoder(p), p.galois_element(1)
    scale = {}

    def run(key):
        k = jax.random.split(key, 5)
        kg = jrlwe.KeyGenerator(p)
        sk = kg.gen_secret_key(k[0])
        ev = jit_gadget_products(jckks.Evaluator(p, jrlwe.EvaluationKeySet(
            kg.gen_relinearization_key(k[1], sk), {rot: kg.gen_galois_key(k[2], rot, sk)})))
        encr = jrlwe.Encryptor(p, sk)
        ca = encr.encrypt(k[3], enc.encode(x["za"]), batch=(cs.BATCH,))
        cb = encr.encrypt(k[4], enc.encode(x["zb"]), batch=(cs.BATCH,))
        out = ev.rotate(ev.rescale(ev.mul_relin(ca, cb)), 1)
        scale["out"] = Fraction(out.scale)
        pt = jrlwe.Decryptor(p, sk).decrypt(out)
        return p.ring_q.intt(pt.value, pt.level)

    coeffs = np.asarray(jax.jit(run, compiler_options=FAST_COMPILE)(
        jax.random.PRNGKey(cs.SEED)))
    print(f"JAX program {time.time() - t0:.0f} s", flush=True)
    got = np.stack([enc.decode(jrlwe.Plaintext(value=c, is_ntt=False, scale=scale["out"]))
                    for c in coeffs])
    st = get_precision_stats(np.roll(x["za"] * x["zb"], -1, axis=-1), got)
    return st.min_precision, st.avg_precision


if __name__ == "__main__":
    import sys
    print(reference_phase10c_bits(int(sys.argv[1]) if len(sys.argv) > 1 else 14))
