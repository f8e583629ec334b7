"""The port's examples as tests, CKKS half (the JAX package's
``tests/test_examples.py``): each ``main()`` of
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


@pytest.mark.parametrize("name", [
    "ckks_tutorial",
    "ckks_sigmoid",
    "ckks_sigmoid_minimax",
    "ckks_vectorized_polynomial_evaluation",
    "ckks_bootstrapping",
    "ckks_bootstrapping_slim",
    "ckks_bootstrapping_high_precision",
])
def test_example(name):
    importlib.import_module(f"lattigo_tpu_torch.examples.{name}").main(device="cpu")
