"""The port's CKKS bootstrapping alone, on its own keys, at the parameters
of the JAX package's slow-tier ``tests/test_bootstrap.py`` (logN 8, 18
limbs, K = 16, degree 30, 4 double angles, message ratio 2^10) with its
precision floor of 8 bits: a batch of two on a leading axis, sparse-secret
encapsulation, the slim circuit order (whole, and staged by hand around a
coefficient-domain circuit), META-BTS and the per-stage debug trace.
``tests/test_torch_bootstrap.py`` holds the standard order bit-equal to
the JAX package, and ``tests/test_torch_bootstrap_orders.py`` the slim
order and META-BTS.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from lattigo_tpu_torch import rlwe as trlwe
from lattigo_tpu_torch.circuits import bootstrapping as tbts
from lattigo_tpu_torch.circuits.mod1 import Mod1Parameters
from lattigo_tpu_torch.schemes import ckks as tckks


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's ops here act on small tensors, where torch's intra-op
    threads only add overhead: one thread runs this file faster and leaves
    the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_params(**kw):
    return tbts.BootstrappingParameters(
        c2s_levels=[4, 3], s2c_levels=[4, 3],
        mod1=Mod1Parameters(k=16, degree=30, double_angle=4,
                            log_message_ratio=10),
        residual_levels=1, **kw)


@pytest.fixture(scope="module")
def own():
    params = tckks.Parameters(tckks.ParametersLiteral(
        log_n=8, log_q=(55,) + (45,) * 3 + (55,) * 14, log_p=(60, 60),
        log_default_scale=45), device="cpu")
    gen = torch.Generator().manual_seed(0)
    kgen = trlwe.KeyGenerator(params)
    sk = kgen.gen_secret_key(gen)
    rlk = kgen.gen_relinearization_key(gen, sk)
    enc = tckks.Encoder(params)
    ev0 = tckks.Evaluator(params, trlwe.EvaluationKeySet(relinearization_key=rlk))
    btp = tbts.BootstrappingEvaluator(params, ev0, enc, _port_params())
    slim = tbts.BootstrappingEvaluator(
        params, ev0, enc, _port_params(circuit_order=tbts.DECODE_THEN_MODUP))
    els = sorted(set(btp.galois_elements()) | set(slim.galois_elements()))
    gks = kgen.gen_galois_keys(gen, els, sk)
    ev = tckks.Evaluator(params, trlwe.EvaluationKeySet(
        relinearization_key=rlk, galois_keys=gks))
    return dict(params=params, sk=sk, enc=enc, ev=ev, gen=gen,
                btp=btp.with_evaluator(ev), slim=slim.with_evaluator(ev))


def _fresh(own, seed, level=0, batch=()):
    params, enc = own["params"], own["enc"]
    rng = np.random.default_rng(seed)
    shape = batch + (params.max_slots,)
    v = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    ct = trlwe.Encryptor(params, own["sk"]).encrypt(
        own["gen"], enc.encode(v), batch=batch).at_level(level)
    return v, ct


def _bits(own, out, v):
    got = own["enc"].decode(trlwe.Decryptor(own["params"], own["sk"]).decrypt(out))
    return float(-np.log2(np.abs(got - v).max()))


def test_own_bootstrap_end_to_end_batched(own):
    """A batch of 2 on a leading axis, refreshed in one pass."""
    v, ct = _fresh(own, 1, batch=(2,))
    out = own["btp"].bootstrap(ct)
    assert out.level == own["btp"].output_level >= 1
    assert tuple(out.value.shape[:1]) == (2,)
    assert _bits(own, out, v) >= 8.0


def test_own_bootstrap_sparse_encapsulated(own):
    """ModUp under an ephemeral H = 16 secret (ia.cr/2022/024)."""
    b = tbts.BootstrappingEvaluator(own["params"], own["ev"], own["enc"],
                                    _port_params(ephemeral_secret_weight=16))
    keys = b.gen_encapsulation_keys(own["gen"], own["sk"])
    assert keys.evk_dense_to_sparse is not None
    v, ct = _fresh(own, 2)
    assert _bits(own, b.bootstrap(ct, keys), v) >= 8.0


def test_own_bootstrap_slim_decode_then_modup(own):
    """S2C → ScaleDown → ModUp → C2S → EvalMod; the output stays in the
    slots domain, above the input level."""
    b = own["slim"]
    assert b.minimum_input_level == 2
    v, ct = _fresh(own, 4, level=b.minimum_input_level)
    out = b.bootstrap(ct)
    assert out.level == b.output_level > b.minimum_input_level
    assert _bits(own, out, v) >= 8.0


def test_own_bootstrap_slim_staged_coeff_circuit(own):
    """The slim stages by hand with a coefficient-domain circuit between
    S2C and ScaleDown: multiplying by X^{N/2} is i in every slot."""
    b, ev, params = own["slim"], own["ev"], own["params"]
    v, ct = _fresh(own, 5, level=b.minimum_input_level)
    ct = b.slots_to_coeffs(ct)
    ring, n = params.ring_q, params.n
    val = ring.intt(ct.value, ct.level)
    shifted = torch.roll(val, n // 2, dims=-1)
    neg = ring.neg(shifted, ct.level)
    val = torch.where(torch.arange(n) < n // 2, neg, shifted)
    ct = ct.replace(value=ring.ntt(val, ct.level))
    ct0 = b.scale_down(ct)
    delta0, q0 = Fraction(ct0.scale), Fraction(params.q_moduli[0])
    ct_re, ct_im = b.coeffs_to_slots(b.mod_up(ct0))
    out = ev.add(b.eval_mod(ct_re), ev.mul_by_i(b.eval_mod(ct_im)))
    out = out.replace(scale=Fraction(out.scale) * delta0 / q0)
    assert _bits(own, out, 1j * v) >= 8.0


def test_own_bootstrap_meta_iterations(own):
    """A second META-BTS iteration on the residual error adds ≥ 3 bits."""
    v, ct = _fresh(own, 3)
    b = own["btp"]
    single = _bits(own, b.bootstrap(ct), v)
    meta = _bits(own, b.bootstrap_meta(ct, iterations=2, log_prec=6), v)
    assert meta >= single + 3.0, f"META-BTS: {single:.1f} → {meta:.1f} bits"


def test_own_bootstrap_sk_debug(own, capsys):
    """with_sk_debug prints one line per stage of the standard order."""
    b = tbts.BootstrappingEvaluator(own["params"], own["ev"], own["enc"],
                                    _port_params()).with_sk_debug(own["sk"])
    _, ct = _fresh(own, 6)
    b.bootstrap(ct)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[sk_debug]")]
    assert [ln.split(":")[0] for ln in lines] == [
        "[sk_debug] scale_down", "[sk_debug] mod_up",
        "[sk_debug] coeffs_to_slots re", "[sk_debug] coeffs_to_slots im",
        "[sk_debug] eval_mod re", "[sk_debug] eval_mod im",
        "[sk_debug] slots_to_coeffs (final)"]
