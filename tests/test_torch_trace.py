"""The port's tracer (``lattigo_tpu_torch/trace.py``) on the CPU: off it is
one shared no-op; on, a CKKS ``mul_relin`` → ``rescale`` →
``lintrans.evaluate`` → ``rescale`` gives the expected tree of spans, self
times are the spans' times less their children's, a synchronizing call
counts against the innermost open span, the spans' host stamps lie inside
their own profiler labels, and the ciphertexts are bit-equal with the
tracer on and off. One test, marked ``cuda``, counts real synchronizing
copies on the card.
"""

import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from lattigo_tpu_torch import rlwe, trace
from lattigo_tpu_torch.circuits import lintrans
from lattigo_tpu_torch.schemes import ckks

LIT = dict(log_n=10, log_q=(40,) * 4, log_p=(41, 41), log_default_scale=30)
BATCH = 2
NDIAG = 16
KS = ("ks.modup", "ks.mac", "ks.moddown")


@pytest.fixture(autouse=True)
def _tracer_off():
    """Every test starts and ends with the tracer off."""
    trace.stop()
    yield
    trace.stop()


@pytest.fixture(scope="module")
def step():
    """A CKKS step at logN 10 (two digits a key switch) and the function
    that runs it: rescale(lintrans(rescale(mul_relin(a, b))))."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    params = ckks.Parameters(ckks.ParametersLiteral(**LIT), device="cpu")
    gen = torch.Generator().manual_seed(5)
    rng = np.random.default_rng(5)
    slots = params.max_slots
    enc = ckks.Encoder(params)
    level = params.max_level - 1
    diags = {k: rng.uniform(-1, 1, slots) / NDIAG for k in range(NDIAG)}
    lt = lintrans.encode_linear_transformation(
        params, diags, lintrans.ckks_diag_encoder(params, enc, params.q_moduli[level]),
        level_q=level, scale=params.q_moduli[level], slots=slots)
    kg = rlwe.KeyGenerator(params)
    sk = kg.gen_secret_key(gen)
    els = lt.galois_elements(params)
    ev = ckks.Evaluator(params, rlwe.EvaluationKeySet(
        kg.gen_relinearization_key(gen, sk),
        kg.gen_galois_keys(gen, els, sk, levels={g: level for g in els})))
    lte = lintrans.LinTransEvaluator(ev)
    encryptor = rlwe.Encryptor(params, sk)
    ca, cb = (encryptor.encrypt(gen, enc.encode(rng.uniform(-1, 1, (BATCH, slots))),
                                batch=(BATCH,)) for _ in range(2))

    def run():
        x = ev.rescale(ev.mul_relin(ca, cb))
        return ev.rescale(lte.evaluate(x, lt)).value

    yield run, lt
    torch.set_num_threads(n)


def test_off_is_one_shared_noop(step):
    run, _ = step
    assert trace.span("ks.mac") is trace.span("ring.ntt")
    with trace.span("ks.mac") as s:
        assert s is None
    run()
    snap = trace.stop()
    assert snap["spans"] == {} and snap["syncs"] == {"total": 0, "outside": 0}


def test_tree_of_the_step(step):
    run, lt = step
    trace.start(cuda=False)
    run()
    snap = trace.stop()
    spans = snap["spans"]
    assert snap["cuda"] is False
    roots = {"ckks.mul_relin": 1, "ckks.rescale": 2, "lintrans.evaluate": 1}
    assert set(spans) == set(roots) | set(KS) | {"ring.ntt"}
    for root, count in roots.items():
        assert spans[root]["count"] == count
        assert set(spans[root]["by_parent"]) == {None}
        assert spans[root]["roots"] == {root: count}
    # the hoisted babies and the giants of the transformation
    babies = {i for b in lt.index.values() for i in b} - {0}
    giants = [j for j in lt.index if j != 0]
    assert giants
    under_lt = {"ks.modup": 2, "ks.mac": len(babies) + 1, "ks.moddown": 3}
    for name in KS:
        by = spans[name]["by_parent"]
        assert set(by) == {"ckks.mul_relin", "lintrans.evaluate"}
        assert by["ckks.mul_relin"]["count"] == 1
        assert by["lintrans.evaluate"]["count"] == under_lt[name]
        assert spans[name]["device_ms"] is None
        assert spans[name]["self_device_ms"] is None
    # the transforms: under ModUp (INTT, then NTT over Q and over P), under
    # ModDown (INTT over P, NTT over Q) and under rescale, none under the MAC
    ntt_by = spans["ring.ntt"]["by_parent"]
    assert set(ntt_by) == {"ks.modup", "ks.moddown", "ckks.rescale"}
    assert ntt_by["ks.modup"]["count"] == 3 * spans["ks.modup"]["count"]
    assert ntt_by["ks.moddown"]["count"] == 2 * spans["ks.moddown"]["count"]
    assert spans["ring.ntt"]["roots"].keys() == roots.keys()


def test_self_time_is_less_the_children(step):
    run, _ = step
    trace.start(cuda=False)
    with trace.span("outer") as outer:
        time.sleep(0.002)
        with trace.span("inner") as a:
            time.sleep(0.003)
        with trace.span("inner") as b:
            time.sleep(0.001)
    run()
    spans = trace.stop()["spans"]
    ns = (outer.t1 - outer.t0) - (a.t1 - a.t0) - (b.t1 - b.t0)
    assert spans["outer"]["self_host_ms"] == pytest.approx(ns / 1e6, rel=1e-12)
    assert spans["outer"]["self_host_ms"] >= 2.0
    assert spans["inner"]["self_host_ms"] == spans["inner"]["host_ms"]
    # the step's spans: each one's self time is its time less the time of
    # the spans whose parent it is
    for name, s in spans.items():
        kids = sum(c["by_parent"].get(name, {}).get("host_ms", 0.0)
                   for c in spans.values())
        assert s["self_host_ms"] == pytest.approx(s["host_ms"] - kids, rel=1e-9,
                                                  abs=1e-9)
        assert 0 <= s["self_host_ms"] <= s["host_ms"]


def test_sync_counts_against_the_innermost_span(monkeypatch):
    """torch reports a synchronizing call as a UserWarning through
    ``warnings.showwarning``, which the tracer replaces on the card; the
    hook is called here as that warning would call it. Other warnings pass
    to the hook it replaced, uncounted."""
    shown = []
    monkeypatch.setattr(trace, "_showwarning", lambda *a: shown.append(a))
    msg = UserWarning(trace.SYNC_MESSAGE + " (Triggered internally at "
                      "c10/cuda/CUDAFunctions.cpp:137.)")
    trace.start(cuda=False)
    trace._capture(msg, UserWarning, "CUDAFunctions.cpp", 137)
    with trace.span("ckks.rescale"):
        trace._capture(msg, UserWarning, "CUDAFunctions.cpp", 137)
        with trace.span("ring.ntt"):
            for _ in range(3):
                trace._capture(msg, UserWarning, "CUDAFunctions.cpp", 137)
        trace._capture(UserWarning("another warning"), UserWarning, "x.py", 1)
    snap = trace.stop()
    assert [str(a[0]) for a in shown] == ["another warning"]
    assert snap["spans"]["ring.ntt"]["syncs"] == 3
    assert snap["spans"]["ckks.rescale"]["syncs"] == 1
    assert snap["syncs"] == {"total": 5, "outside": 1}


def test_stamps_lie_inside_the_profiler_labels(step):
    """The spans' time.time_ns() stamps and torch.profiler's event times
    share one clock: each span lies inside its own record_function range."""
    run, _ = step
    trace.start(cuda=False)
    handles = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(5):
            with trace.span(f"probe{k}") as s:
                run()
            handles.append(s)
    trace.stop()
    ranges = {ev.name(): (ev.start_ns(), ev.end_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("lattigo.probe")
              and ev.device_type() == DeviceType.CPU}
    assert len(ranges) == 5
    for k, s in enumerate(handles):
        start, end = ranges[f"lattigo.probe{k}"]
        assert start <= s.t0 < s.t1 <= end


def test_bit_equal_with_the_tracer_on_and_off(step):
    run, _ = step
    off = run()
    trace.start(cuda=False)
    on = run()
    trace.stop()
    assert torch.equal(off, on)


@pytest.mark.cuda
def test_card_counts_a_pageable_copy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    host = torch.arange(1 << 20, dtype=torch.int64)
    pinned = host.pin_memory()
    torch.cuda.synchronize()
    trace.start(cuda=True)
    with trace.span("pageable"):
        host.to("cuda")
    with trace.span("pinned"):
        pinned.to("cuda", non_blocking=True)
    snap = trace.stop()
    assert snap["spans"]["pageable"]["syncs"] == 1
    assert snap["spans"]["pinned"]["syncs"] == 0
    assert snap["syncs"]["outside"] == 0
    assert snap["spans"]["pageable"]["device_ms"] >= 0
    assert torch.cuda.get_sync_debug_mode() == 0
