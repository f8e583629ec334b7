"""Homomorphic schemes (BGV/BFV, CKKS)."""
