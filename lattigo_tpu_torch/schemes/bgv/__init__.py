"""BGV/BFV: exact integer SIMD arithmetic over Z_T."""

from lattigo_tpu_torch.schemes.bgv.params import Parameters, ParametersLiteral
from lattigo_tpu_torch.schemes.bgv.encoder import Encoder
from lattigo_tpu_torch.schemes.bgv.evaluator import Evaluator

__all__ = ["Parameters", "ParametersLiteral", "Encoder", "Evaluator"]
