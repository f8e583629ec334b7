"""Scheme-generic RLWE core: parameters, ciphertexts, keys, sk encryption
and the gadget-product key switch."""

from lattigo_tpu_torch.rlwe.params import (
    Parameters, ParametersLiteral,
    DiscreteGaussian, Ternary, Uniform, DEFAULT_XE, DEFAULT_XS,
)
from lattigo_tpu_torch.rlwe.elements import Ciphertext, Plaintext, ciphertext_from_polys
from lattigo_tpu_torch.rlwe.keys import (
    SecretKey, GadgetCiphertext, RelinearizationKey, KeyGenerator,
    EvaluationKeySet,
)
from lattigo_tpu_torch.rlwe.encryption import Encryptor, Decryptor, add_plaintext
from lattigo_tpu_torch.rlwe.evaluator import Evaluator

__all__ = [
    "Parameters", "ParametersLiteral",
    "DiscreteGaussian", "Ternary", "Uniform", "DEFAULT_XE", "DEFAULT_XS",
    "Ciphertext", "Plaintext", "ciphertext_from_polys",
    "SecretKey", "GadgetCiphertext", "RelinearizationKey", "KeyGenerator",
    "EvaluationKeySet", "Encryptor", "Decryptor", "add_plaintext", "Evaluator",
]
