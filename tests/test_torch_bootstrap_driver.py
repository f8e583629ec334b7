"""The port's bootstrap driver (``lattigo_tpu_torch/circuits/
bootstrap_driver.py``, ``bench_bootstrap_torch.py``) on the CPU: its
command line, its JSON line's schema and its precision, not its timings.

It runs once (``--once``) at the smallest preset the JAX package's tests
bootstrap, ``N15QP768_H192_H32`` at logN 9 (``tests/test_preset_recipes.py``).
Floor: that file's record of the JAX package's CPU result there, 17.1 worst
/ 19.1 mean bits, less one bit.
"""

import json

import pytest
import torch

from lattigo_tpu_torch.circuits import bootstrap_driver

PRESET, LOG_N = "N15QP768_H192_H32", 9
FLOOR = (16.1, 18.1)
KEYS = {"metric", "value", "unit", "batch", "log_n", "slots", "setup_s", "first_s",
        "precision_bits", "precision_avg_bits", "windows", "iters", "spread",
        "stage_ms", "peak_mib", "engine", "device"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_preset_once(capsys):
    assert bootstrap_driver.main(["--preset", PRESET, "--log-n", str(LOG_N), "--once",
                                  "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1
    res = json.loads(line[0])
    assert set(res) == KEYS
    assert res["metric"] == f"ckks_bootstrap_{PRESET}" and res["unit"] == "s/bootstrap"
    assert (res["batch"], res["log_n"], res["slots"]) == (1, LOG_N, 1 << (LOG_N - 1))
    assert (res["windows"], res["iters"], res["spread"]) == (1, 1, 1.0)
    assert list(res["stage_ms"]) == ["ScaleDown", "C2S", "EvalMod", "S2C"]
    assert all(v > 0 for v in res["stage_ms"].values())
    assert res["value"] > 0 and res["setup_s"] > 0 and res["first_s"] > 0
    assert res["peak_mib"] is None and res["device"] == {"platform": "cpu", "kind": "cpu"}
    assert res["engine"] == "radix2-plain"
    assert res["precision_bits"] >= FLOOR[0] and res["precision_avg_bits"] >= FLOOR[1]


def test_arguments():
    assert bootstrap_driver.parameters(12)[0] == "logN12"
    name, residual, lit = bootstrap_driver.parameters(preset=PRESET, preset_log_n=10)
    assert (name, residual.log_n, lit.ephemeral_secret_weight) == (PRESET, 10, 32)
    with pytest.raises(SystemExit):
        bootstrap_driver.main(["--log-n", "9", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bootstrap_driver.run(8)
