"""Circuits over the schemes: slot-space linear transformations,
Paterson–Stockmeyer polynomial evaluation (CKKS and exact BGV), homomorphic
DFT, mod-1 (EvalMod), minimax composite polynomials, sign and comparison,
inverse, and CKKS bootstrapping with its published presets."""

from lattigo_tpu_torch.circuits import (
    lintrans, polynomial, bgv_polynomial, dft, mod1, minimax, comparison,
    inverse, bootstrapping, bootstrapping_presets,
)

__all__ = ["lintrans", "polynomial", "bgv_polynomial", "dft", "mod1",
           "minimax", "comparison", "inverse", "bootstrapping",
           "bootstrapping_presets"]
