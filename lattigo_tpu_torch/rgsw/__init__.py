"""RGSW ciphertexts, the external product and LMKCDEY blind rotation.

Counterpart of :mod:`lattigo_tpu.rgsw`. An RGSW(m) ciphertext is a pair of
gadget ciphertexts under one key, the first carrying m·g on the c0
component and the second on c1; the external product RLWE ⊠ RGSW gives
RLWE(μ·m). :mod:`.blindrot` builds programmable bootstrapping on it.
"""

from lattigo_tpu_torch.rgsw.rgsw import Ciphertext, Encryptor, external_product

__all__ = ["Ciphertext", "Encryptor", "external_product"]
