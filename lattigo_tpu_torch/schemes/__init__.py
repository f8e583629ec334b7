"""Homomorphic schemes (BGV/BFV)."""
