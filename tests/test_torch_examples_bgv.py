"""The port's examples as tests, BGV and multiparty half (the JAX
package's ``tests/test_examples.py``): each ``main()`` of
``lattigo_tpu_torch/examples`` runs end to end on the CPU with the JAX
test's arguments; the asserts inside are the oracles."""

import importlib

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """At these sizes torch's intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(name: str, **kwargs):
    importlib.import_module(f"lattigo_tpu_torch.examples.{name}").main(
        device="cpu", **kwargs)


@pytest.mark.parametrize("name,kwargs", [
    ("bgv_vectorized_ole", {}),
    ("bgv_ride_hailing", dict(n_drivers=8)),
    ("multiparty_psi", {}),
    ("thresh_eval_key_gen", dict(n_parties=3, t=2)),
    ("int_pir", dict(n_parties=2)),
    ("template_bgv", {}),
    ("template_ckks", {}),
    ("ckks_scheme_switching", {}),
])
def test_example(name, kwargs):
    _run(name, **kwargs)


@pytest.mark.slow   # ~60 s alone on one CPU thread
def test_rgsw_blind_rotations():
    _run("rgsw_blind_rotations")
