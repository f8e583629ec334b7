"""Typed errors for evaluation-key lookups.

Counterpart of :mod:`lattigo_tpu.rlwe.errors`: a missing key is a user
error whose message says which key is missing and how to generate it.
Both classes are :class:`MissingKeyError`, so a ``KeyError``.
"""

from __future__ import annotations


class MissingKeyError(KeyError):
    """An evaluation key required by the requested operation is absent."""

    def __str__(self) -> str:  # KeyError quotes its argument; keep it readable
        return self.args[0]


class MissingGaloisKeyError(MissingKeyError):
    def __init__(self, gal_el: int, rotation: int | None = None):
        self.gal_el = gal_el
        self.rotation = rotation
        hint = "" if rotation is None else f" (slot rotation by {rotation})"
        super().__init__(
            f"GaloisKey for element {gal_el}{hint} is missing from the "
            f"EvaluationKeySet — generate it with "
            f"KeyGenerator.gen_galois_keys(gen, [{gal_el}], sk)")


class MissingRelinearizationKeyError(MissingKeyError):
    def __init__(self):
        super().__init__(
            "RelinearizationKey is missing from the EvaluationKeySet — "
            "generate it with KeyGenerator.gen_relinearization_key(gen, sk)")
