"""CKKS: approximate arithmetic over C^{N/2}."""

from lattigo_tpu_torch.schemes.ckks.params import Parameters, ParametersLiteral
from lattigo_tpu_torch.schemes.ckks.encoder import Encoder, PrecisionEncoder
from lattigo_tpu_torch.schemes.ckks.evaluator import Evaluator
from lattigo_tpu_torch.schemes.ckks.precision import (
    PrecisionStats, get_precision_stats, verify_test_vectors,
)

__all__ = [
    "Parameters", "ParametersLiteral", "Encoder", "PrecisionEncoder",
    "Evaluator", "PrecisionStats", "get_precision_stats", "verify_test_vectors",
]
