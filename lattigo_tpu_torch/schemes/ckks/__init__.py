"""CKKS: approximate arithmetic over C^{N/2} (R^N on the conjugate-invariant
ring)."""

from lattigo_tpu_torch.schemes.ckks.params import Parameters, ParametersLiteral
from lattigo_tpu_torch.schemes.ckks.encoder import CIEncoder, Encoder, PrecisionEncoder
from lattigo_tpu_torch.schemes.ckks.evaluator import Evaluator
from lattigo_tpu_torch.schemes.ckks.precision import (
    PrecisionStats, get_precision_stats, verify_test_vectors,
)

__all__ = [
    "Parameters", "ParametersLiteral", "Encoder", "CIEncoder", "PrecisionEncoder",
    "Evaluator", "PrecisionStats", "get_precision_stats", "verify_test_vectors",
]
