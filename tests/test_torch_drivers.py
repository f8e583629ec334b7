"""The port's counterparts of two root drivers, on the CPU.

``validate_presets_torch.py`` (``lattigo_tpu_torch.circuits
.preset_validator``): its arguments, its default list (that of
``validate_presets.py``, read from that script's source) and its line,
with ``run_recipe`` patched so that no bootstrap runs.

``bench_scaling_torch.py`` (``lattigo_tpu_torch.parallel.scaling``): the
JAX script's step at logN 10 on a batch of 4, in this process and on 2
gloo ranks (``parallel/launch.py``) with the batch sharded over dp. The
dp axis moves no byte (``Mesh.stats``), the gathered result equals the
one-process result bit for bit, and the JSON line has the JAX script's
keys.
"""

import ast
import json
import re
from pathlib import Path

import pytest
import torch

from lattigo_tpu_torch.circuits import bootstrapping_presets as bp
from lattigo_tpu_torch.circuits import preset_validator
from lattigo_tpu_torch.parallel import scaling

ROOT = Path(__file__).resolve().parents[1]
# bench_scaling.py's JSON keys, in its order
SCALING_KEYS = ["metric", "n_devices", "batch", "collectives_on_dp_axis", "bit_exact",
                "t_1dev_s", "t_Ndev_s", "wallclock_ratio_shared_cores"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_default_presets() -> list[str]:
    """The name list of ``validate_presets.py``'s ``args or [...]``."""
    tree = ast.parse((ROOT / "validate_presets.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.BoolOp) and isinstance(node.values[-1], ast.List):
            return [e.value for e in node.values[-1].elts]
    raise AssertionError("no default list in validate_presets.py")


@pytest.fixture
def fake_recipe(monkeypatch):
    calls = []

    def run_recipe(preset, log_n=None, seed=0, data_seed=1, device=None):
        calls.append((preset, log_n, device))
        return 17.06, 19.14

    monkeypatch.setattr(bp, "run_recipe", run_recipe)
    return calls


def test_validator_default_list(fake_recipe, capsys):
    assert list(preset_validator.DEFAULT_PRESETS) == _jax_default_presets()
    out = preset_validator.main(["--device", "cpu"])
    assert list(out) == _jax_default_presets()
    assert [c[0] for c in fake_recipe] == [getattr(bp, n) for n in out]
    assert {(c[1], str(c[2])) for c in fake_recipe} == {(9, "cpu")}
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 8


@pytest.mark.parametrize("argv,log_n", [
    (["N16QP1553_H192_H32", "--log-n", "10", "--device", "cpu"], 10),
    (["--log-n", "8", "N16QP1553_H192_H32", "N15QP768_H192_H32", "--device", "cpu"], 8),
])
def test_validator_arguments_and_line(fake_recipe, capsys, argv, log_n):
    names = [a for a in argv if a.startswith("N1")]
    out = preset_validator.main(argv)
    assert list(out) == names
    assert [c[1] for c in fake_recipe] == [log_n] * len(names)
    lines = capsys.readouterr().out.splitlines()
    for name, line in zip(names, lines, strict=True):
        assert re.fullmatch(rf"{name} @ logN={log_n}: 17\.1 bits worst-slot / 19\.1 avg "
                            r"\(\d+s\)", line), line
        assert out[name][:2] == (17.06, 19.14)


def test_validator_default_device(fake_recipe):
    """No --device: the card, or a RuntimeError without one."""
    if torch.cuda.is_available():
        preset_validator.main(["N15QP768_H192_H32"])
        assert [c[2].type for c in fake_recipe] == ["cuda"]
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        preset_validator.main(["N15QP768_H192_H32"])
    assert not fake_recipe


@pytest.fixture(scope="module")
def scaled():
    """The scaling line at logN 10, batch 4, 2 gloo ranks."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = scaling.run(2, 4, "cpu", log_n=10, reps=1)
    return res, buf.getvalue()


def test_scaling_line_keys(scaled):
    res, out = scaled
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == SCALING_KEYS
    assert line["metric"] == "dp_scaling_batched_ckks_eval"
    assert (line["n_devices"], line["batch"]) == (2, 4)
    assert (res["log_n"], res["backend"], res["local_shape"][0]) == (10, "gloo", 2)
    assert line["t_1dev_s"] > 0 and line["t_Ndev_s"] > 0


def test_scaling_dp_moves_nothing(scaled):
    assert scaled[0]["collectives_on_dp_axis"] == 0


def test_scaling_rank_launches(scaled):
    """Each rank reports both kernels' launches over its steps: none on
    the CPU, where the wrappers run their plain versions."""
    launches = scaled[0]["rank_launches"]
    assert len(launches) == 2
    for rank in launches:
        assert rank == {"ntt_mxu": {"forward": 0, "inverse": 0},
                        "ntt_pallas": {"forward": 0, "inverse": 0}}


def test_scaling_bit_exact(scaled):
    assert scaled[0]["bit_exact"] is True


def test_scaling_batch_must_divide():
    with pytest.raises(ValueError, match="divide"):
        scaling.run(3, 4, "cpu", log_n=10)
