"""Scheme-generic RLWE core: parameters, ciphertexts, keys (incl. Galois
keys), sk encryption, the gadget-product key switch and automorphisms."""

from lattigo_tpu_torch.rlwe.params import (
    Parameters, ParametersLiteral,
    DiscreteGaussian, Ternary, Uniform, DEFAULT_XE, DEFAULT_XS,
)
from lattigo_tpu_torch.rlwe.elements import Ciphertext, Plaintext, ciphertext_from_polys
from lattigo_tpu_torch.rlwe.keys import (
    SecretKey, GadgetCiphertext, RelinearizationKey, GaloisKey, KeyGenerator,
    EvaluationKeySet,
)
from lattigo_tpu_torch.rlwe.errors import MissingGaloisKeyError, MissingKeyError
from lattigo_tpu_torch.rlwe.encryption import Encryptor, Decryptor, add_plaintext
from lattigo_tpu_torch.rlwe.evaluator import Evaluator

__all__ = [
    "Parameters", "ParametersLiteral",
    "DiscreteGaussian", "Ternary", "Uniform", "DEFAULT_XE", "DEFAULT_XS",
    "Ciphertext", "Plaintext", "ciphertext_from_polys",
    "SecretKey", "GadgetCiphertext", "RelinearizationKey", "GaloisKey",
    "KeyGenerator", "EvaluationKeySet", "MissingGaloisKeyError", "MissingKeyError", "Encryptor", "Decryptor", "add_plaintext", "Evaluator",
]
