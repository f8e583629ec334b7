"""Circuits over the schemes: slot-space linear transformations."""

from lattigo_tpu_torch.circuits import lintrans

__all__ = ["lintrans"]
