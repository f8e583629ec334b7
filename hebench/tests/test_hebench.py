"""CPU tests of the benchmark at small sizes: the request kinds against the
NumPy reference, the control and the timed path's faults failing the
check, the transform count of the roofline readers, the result line's
schema, and what a run may not import.

    python -m pytest -q -p no:cacheprovider hebench/tests
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hebench import run
from hebench.control import float64_products
from hebench.reference import ckks as ref
from hebench.reference import rns

ROOT = Path(run.HERE).parent
SEED = 2**31 + 977                      # past 32 signed bits
E2E = ["ct_per_s", "req_p95_ms", "bootstrap_s", "peak_mem_gib", "setup_s"]
PER_LAYER = ["mul_relin_ms", "rescale_ms", "lintrans_ms", "evalmod_ms", "dft_ms",
             "host_issue_ms", "torch_ops_per_btp", "ntt_roofline.ct", "ntt_roofline.btp",
             "idle_share.ct", "idle_share.btp", "key_mem_gib"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cell(cell: str, log_n: int | None = None,
               log_q: list[int] | None = None) -> tuple[dict, dict, dict]:
    """(configuration, traffic, limits) of a cell at a size the CPU holds:
    the same prime sizes at a smaller ring degree (``log_n``; 12, or 10
    for the bootstrap, unless given) and, for the logN-16 chain, its first
    five levels (or the sizes ``log_q``); every sampled ciphertext
    checked."""
    from lattigo_tpu_torch.rlwe.params import gen_moduli

    bench = run.load_json(ROOT / "BENCHMARK.json")
    w = {c["name"]: c for c in bench["workloads"]}[cell]
    cfg = run.load_json(run.HERE / "configs" / f"{w['config']}.json")
    traffic = run.load_json(run.HERE / "traffic" / f"{w['traffic']}.json")
    limits = run.load_json(run.HERE / "limits" / f"{cell}.json")
    if "residual" in cfg:
        cfg["log_n"] = log_n or 10
        log_p = cfg["residual"]["log_p"]
    else:
        cfg.update(log_n=log_n or 12, log_q=log_q or cfg["log_q"][:5])
        log_p = cfg["log_p"]
    cfg["q"], cfg["p"] = gen_moduli(cfg["log_n"], 2 << cfg["log_n"],
                                    tuple(cfg["log_q"]), tuple(log_p))
    if traffic["kind"] == "ckks_ptmul":
        traffic.update(batch=8, weights=4, profile_requests=2)
    traffic["sample_ct"] = traffic.get("batch")
    return cfg, traffic, limits


def run_small(cell: str, seconds: float = 0.5, trace: bool = False, patch=None):
    cfg, traffic, limits = small_cell(cell)
    with patch or contextlib.nullcontext():
        return run.run_cell(cfg, traffic, limits, SEED, seconds, trace, "cpu", 0.0,
                            [{"name": n, "unit": "-"} for n in E2E],
                            [{"name": n, "unit": "-"} for n in PER_LAYER])


CELLS = ["ckks16.step", "ckks16.ptmul", "btp15.chain"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_agrees_with_reference(cell):
    res = run_small(cell)
    checks = res["checks"]
    assert res["correct"], checks
    assert checks["crt_mismatch"]["value"] == 0
    assert checks["max_err_log2"]["value"] < checks["max_err_log2"]["limit"] - 4


def test_result_schema():
    res = run_small("ckks16.step", trace=True)
    assert set(res) == {"correct", "attempted", "failed", "metrics", "device",
                        "breakdown", "checks"}
    assert list(res)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res, allow_nan=False)
    plain = run_small("ckks16.step")
    assert {"ct_per_s", "setup_s"} <= set(plain["metrics"])
    for m in plain["metrics"].values():
        assert m["value"] > 0


def test_control_fails():
    """The program with float64 residue products, on three seeds."""
    cfg, traffic, limits = small_cell("ckks16.step")
    for seed in (SEED, SEED + 1, SEED + 2):
        with float64_products():
            res = run.run_cell(cfg, traffic, limits, seed, 0.2, False, "cpu", 0.0, [], [])
        assert not res["correct"]
        assert res["checks"]["crt_mismatch"]["value"] > 0


def _broken_request(kind_fault: str):
    """Plant one fault of the timed path in every request's output."""
    from hebench.kinds import bootstrap_chain, ckks_ptmul, ckks_step

    def unchanged(self, i, orig):
        if hasattr(self, "btp"):
            orig(self, i)
            return self.ct                 # the bootstrap hands back its input
        if hasattr(self, "lt"):
            ia, _ = self.idx[i % self.pool]
            return self.pool_ct.replace(value=self.pool_ct.value[ia])
        return self.ct

    def half_batch(self, i, orig):
        out = orig(self, i)
        v = out.value.reshape((-1,) + out.value.shape[-3:])
        h = v.shape[0] // 2
        kept = v[:h]
        # the left-out half answered by the kept half (their mean is no
        # ciphertext: the kept ones stand in for it)
        v = torch.cat([kept, kept[: v.shape[0] - h]])
        return out.replace(value=v.reshape(out.value.shape))

    def altered(self, i, orig):
        out = orig(self, i)
        v = out.value.clone()
        q0 = int(self.params.q_moduli[0])
        flat = v.reshape((-1,) + v.shape[-3:])
        flat[:, 0, 0, 0] = (flat[:, 0, 0, 0] + q0 // 2) % q0
        return out.replace(value=v)

    fault = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}[kind_fault]

    @contextlib.contextmanager
    def patch():
        kinds = (ckks_step.Cell, ckks_ptmul.Cell, bootstrap_chain.Cell)
        orig = {k: k.request for k in kinds}
        for k in kinds:
            k.request = (lambda o: lambda self, i: fault(self, i, o))(orig[k])
        try:
            yield
        finally:
            for k in kinds:
                k.request = orig[k]
    return patch()


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_fails(cell, fault):
    res = run_small(cell, seconds=0.2, patch=_broken_request(fault))
    assert not res["correct"], res["checks"]


def test_transform_count():
    """The residues the wrapped ring entries count equal those the plain
    engines underneath transform, at a small size of each route: the
    cells' own primes (the u64 engine) and 28-bit ones (the four-step
    kernel's route)."""
    from lattigo_tpu_torch.ring import ntt as ntt_mod, ntt_mxu, ntt_u64_mxu
    from hebench.trace import Trace

    for cell, log_q, engine in (("ckks16.step", None, "mxu64-plain"),
                                ("ckks16.step", [28] * 5, "mxu-plain"),
                                ("btp15.chain", None, "mxu64-plain")):
        cfg, traffic, _ = small_cell(cell, 12, log_q)
        seen = [0]

        def count(fn, pos):
            def wrapped(*a, **kw):
                seen[0] += a[pos].numel()
                return fn(*a, **kw)
            return wrapped

        saved = [(ntt_mod, "ntt"), (ntt_mod, "intt"), (ntt_mxu, "four_step_plain"),
                 (ntt_u64_mxu.NTTMxu64, "_apply")]
        orig = [getattr(o, n) for o, n in saved]
        trace = Trace(True, cuda=False)
        kind = __import__(f"hebench.kinds.{traffic['kind']}", fromlist=["Cell"])
        c = kind.Cell(cfg, traffic, SEED, "cpu", trace)
        try:
            ntt_mod.ntt, ntt_mod.intt = count(orig[0], 0), count(orig[1], 0)
            ntt_mxu.four_step_plain = count(orig[2], 1)
            ntt_u64_mxu.NTTMxu64._apply = count(orig[3], 1)
            trace.recording = True
            with trace.transforms():
                c.request(0)
        finally:
            for (o, n), f in zip(saved, orig):
                setattr(o, n, f)
        totals = trace.ntt_totals()
        assert seen[0] > 0 and c.params.ring_q.ntt_engine == engine
        assert totals["residues"] == seen[0]


def test_reference_transform_round_trip():
    n = 1 << 10
    from lattigo_tpu_torch.utils.primes import generate_ntt_primes

    qs = generate_ntt_primes(28, 2 * n, 2) + generate_ntt_primes(50, 2 * n, 1)
    x = np.random.default_rng(1).integers(0, 1 << 27, (3, n)).astype(np.uint64)
    assert np.array_equal(rns.intt(rns.ntt(x, qs), qs), x)
    # products of residues below 2^62, exact on either path of mulmod
    r = np.random.default_rng(3)
    for q in (qs[2], generate_ntt_primes(56, 2 * n, 1)[0], (1 << 61) - 1):
        a = r.integers(0, q, 4096, dtype=np.uint64)
        b = r.integers(0, q, 4096, dtype=np.uint64)
        a[:2], b[:2] = q - 1, (q - 1, q - 2)
        want = [(int(x) * int(y)) % q for x, y in zip(a, b)]
        for extended in {rns._EXTENDED, False}:
            saved, rns._EXTENDED = rns._EXTENDED, extended
            try:
                assert rns.mulmod(a, b, np.uint64(q)).tolist() == want
            finally:
                rns._EXTENDED = saved


def test_decode_inverts_embedding():
    n = 1 << 8
    rng = np.random.default_rng(2)
    z = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
    e = np.ones(n // 2, dtype=np.int64)
    for j in range(1, n // 2):
        e[j] = e[j - 1] * 5 % (2 * n)
    k = np.arange(n)
    # m_k = (1/N)·Σ_j (z_j ζ^(-e_j k) + conj(z_j) ζ^(e_j k)), real
    zeta = np.exp(1j * np.pi / n)
    m = (2.0 / n) * np.real(np.sum(z[:, None] * zeta ** (-np.outer(e, k)), axis=0))
    got = ref.decode(np.round(m * 2**30).astype(np.int64), 2**30)
    assert np.max(np.abs(got - z)) < 1e-6


def test_run_imports_no_jax():
    """A run's process holds none of jax, jaxlib, flax or the JAX package,
    compared by whole top-level names (the port's name begins with the JAX
    package's)."""
    code = ("import sys; "
            "from hebench.tests.test_hebench import run_small; from hebench import run; "
            "res = run_small('ckks16.step', trace=True); "
            "print(res['correct'], run.forbidden_modules(), "
            "'lattigo_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True [] True"


def test_forbidden_names_are_whole():
    before = dict(sys.modules)
    try:
        sys.modules["lattigo_tpu_torch_probe"] = object()
        assert "lattigo_tpu" not in run.forbidden_modules() or "lattigo_tpu" in before
        sys.modules["jaxlib.probe"] = object()
        assert "jaxlib" in run.forbidden_modules()
    finally:
        for k in ("lattigo_tpu_torch_probe", "jaxlib.probe"):
            sys.modules.pop(k, None)


def test_no_card_no_result(tmp_path):
    """Without a CUDA device, or in a checkout of the benchmark alone, a run
    exits non-zero and prints no result line."""
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(run.HERE), str(tmp_path / "hebench")], check=True)
    for cwd in ([tmp_path] if torch.cuda.is_available() else [ROOT, tmp_path]):
        out = subprocess.run([sys.executable, "-m", "hebench", "--workload", "ckks16.step",
                              "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                             cwd=cwd, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"correct"' not in out.stdout


@pytest.mark.cuda
def test_cell_on_card():
    """One short run of each cell on the card (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for cell in CELLS:
        out = subprocess.run([sys.executable, "-m", "hebench", "--workload", cell,
                              "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
                             cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-2000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"] and not math.isnan(res["metrics"]["setup_s"]["value"])
