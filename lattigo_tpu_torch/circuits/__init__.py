"""Circuits over the schemes: slot-space linear transformations,
Paterson–Stockmeyer polynomial evaluation, homomorphic DFT, mod-1
(EvalMod) and CKKS bootstrapping with its published presets."""

from lattigo_tpu_torch.circuits import (
    lintrans, polynomial, dft, mod1, bootstrapping, bootstrapping_presets,
)

__all__ = ["lintrans", "polynomial", "dft", "mod1", "bootstrapping",
           "bootstrapping_presets"]
