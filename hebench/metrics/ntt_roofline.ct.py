"""ntt_roofline.ct: the least time of the traced window's transforms over
their measured time, in %, in the cells whose requests are ciphertext
products. Work from the transforms' shapes alone: each residue read once
and written once, 4 B where q < 2^32 and 8 B otherwise, at the H100's HBM
bandwidth; no twiddle table and no operation of the implementation is
counted, so the share reads the same whichever engine the primes select.
Time: CUDA events around each call of the ring's transform entries,
summed."""

from hebench.peaks import HBM_BYTES_PER_S


def read(r):
    t = r.ntt
    if not t or t["ms"] <= 0:
        return None
    return t["bytes"] / HBM_BYTES_PER_S * 1e3 / t["ms"] * 100
