"""Typed errors for evaluation-key lookups.

Counterpart of :mod:`lattigo_tpu.rlwe.errors`: a missing key is a user
error whose message says which key is missing and how to generate it.
"""

from __future__ import annotations


class MissingKeyError(KeyError):
    """An evaluation key required by the requested operation is absent."""

    def __str__(self) -> str:  # KeyError quotes its argument; keep it readable
        return self.args[0]


class MissingGaloisKeyError(MissingKeyError):
    def __init__(self, gal_el: int):
        self.gal_el = gal_el
        super().__init__(
            f"GaloisKey for element {gal_el} is missing from the "
            f"EvaluationKeySet — generate it with "
            f"KeyGenerator.gen_galois_keys(gen, [{gal_el}], sk)")
