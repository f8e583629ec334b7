"""The port's GPU gate (``lattigo_tpu_torch/gate.py``, ``gpu_gate.py``) on
the CPU, where every engine is its plain version.

* ``gate_kat``: the port's known-answer vectors (Lattigo's sizes, N = 16 …
  512 on two 60-bit primes, answers from the transform's definition in
  Python integers) go through the JAX package's own ``tpu_gate.gate_kat``,
  as the JAX tests run it on the CPU: its jitted NTT and INTT must be
  bit-exact to them. The port's ``gate_kat`` passes on the same vectors.
* ``gate_engines`` on the gate's engine classes at logN ≤ 13: the four-step
  and u32 plain versions and the u64 four-step engine equal to radix-2, the
  ModUp digit matmul equal to the raw multiply-accumulate;
* ``gate_bootstrap`` (≥ 8 bits at logN 8) and ``gate_preset`` at logN 10
  (worst ≥ 15.0 / mean ≥ 17.0 bits, ``tpu_gate.py``'s thresholds);
* the entry: no device and no card raises; a broken known answer fails
  the run with the gate's error, and nothing is caught.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_lattigo_vectors as jvec
from lattigo_tpu_torch import gate

ROOT = Path(__file__).resolve().parents[1]
# the gate's engine classes at the CPU's sizes: four-step, u32 (30-bit, and
# 28-bit below the four-step kernel's N), u64 four-step (50-bit, mixed)
CPU_CHAINS = [("mxu", 12, [28, 28]), ("u32", 10, [30, 30]), ("u32", 11, [28, 28]),
              ("mxu64", 12, [50, 50]), ("mxu64", 13, [25, 50, 61])]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_kat_bit_exact_to_jax_gate(monkeypatch):
    vectors = gate.definition_vectors()
    assert [v[0] for v in vectors] == [16, 32, 64, 128, 256, 512]
    assert all(len(v[1]) == 2 and all(q.bit_length() == 60 for q in v[1]) for v in vectors)
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setattr(sys, "path", list(sys.path))    # tpu_gate adds "tests"
    import tpu_gate
    monkeypatch.setattr(jvec, "_parse_reference_vectors", lambda: vectors)
    tpu_gate.gate_kat()
    res = gate.gate_kat("cpu")
    assert res["vectors"] == 6 and res["engines"] == ["radix2-plain"]


def test_engines_against_radix2():
    res = gate.gate_engines("cpu", chains=CPU_CHAINS, mod_up_log_n=12)
    assert [c["engine"] for c in res["chains"]] == [
        "mxu-plain", "u32-plain", "u32-plain", "mxu64-plain", "mxu64-plain"]
    assert all(c["checks"] == 4 for c in res["chains"])
    assert res["mod_up"] == "(2, 13, 4096) -> (2, 2, 4096)"


def test_gate_chains_take_their_engines():
    """The card's chains select the engine each is there for (metadata):
    the four-step kernel at logN 13-16 on 28-bit primes, the u32 kernel
    at logN 15 on 30-bit ones."""
    from lattigo_tpu_torch.ring.ring import select_engine
    chains = gate.engine_chains()
    assert {(e, n) for e, n, b in chains if b == [28, 28]} == {
        ("mxu", 13), ("mxu", 14), ("mxu", 15), ("mxu", 16)}
    assert ("u32", 15, [30, 30]) in chains
    for full in (False, True):
        for engine, log_n, bits in gate.engine_chains(full):
            primes = gate._chain_primes(log_n, bits)
            assert all(q < (1 << b) for q, b in zip(primes, bits))
            assert select_engine(1 << log_n, primes) == engine


def test_bootstrap_and_preset():
    b = gate.gate_bootstrap("cpu")
    assert b["worst_bits"] >= 8.0
    p = gate.gate_preset("cpu")
    assert p["log_n"] == 10 and p["worst_bits"] >= 15.0 and p["mean_bits"] >= 17.0


def test_entry_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        gate.main([])


def test_broken_gate_fails_the_run(monkeypatch):
    n, q, a, b = gate.definition_vectors()[0]
    b = b.copy()
    b[0, 3] ^= np.uint64(1)
    monkeypatch.setattr(gate, "definition_vectors", lambda: [(n, q, a, b)])
    with pytest.raises(gate.GateFailure, match="KAT N=16"):
        gate.main(["--device", "cpu"])
