"""Scheme-generic RLWE core: parameters, ciphertexts, keys (secret, public,
evaluation, relinearization, Galois; compressed gadgets), sk and pk
encryption, the gadget-product key switch and automorphisms."""

from lattigo_tpu_torch.rlwe.params import (
    Parameters, ParametersLiteral,
    DiscreteGaussian, Ternary, Uniform, DEFAULT_XE, DEFAULT_XS,
)
from lattigo_tpu_torch.rlwe.elements import Ciphertext, Plaintext, ciphertext_from_polys
from lattigo_tpu_torch.rlwe.keys import (
    SecretKey, PublicKey, GadgetCiphertext, CompressedGadgetCiphertext,
    EvaluationKey, RelinearizationKey, GaloisKey, KeyGenerator,
    EvaluationKeySet, compress_gadget,
)
from lattigo_tpu_torch.rlwe.errors import (
    MissingGaloisKeyError, MissingKeyError, MissingRelinearizationKeyError,
)
from lattigo_tpu_torch.rlwe.encryption import Encryptor, Decryptor, add_plaintext
from lattigo_tpu_torch.rlwe.evaluator import Evaluator

__all__ = [
    "Parameters", "ParametersLiteral",
    "DiscreteGaussian", "Ternary", "Uniform", "DEFAULT_XE", "DEFAULT_XS",
    "Ciphertext", "Plaintext", "ciphertext_from_polys",
    "SecretKey", "PublicKey", "GadgetCiphertext", "CompressedGadgetCiphertext",
    "EvaluationKey", "compress_gadget", "RelinearizationKey", "GaloisKey",
    "KeyGenerator", "EvaluationKeySet", "MissingGaloisKeyError", "MissingKeyError",
    "MissingRelinearizationKeyError", "Encryptor", "Decryptor", "add_plaintext",
    "Evaluator",
]
