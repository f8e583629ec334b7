"""ntt_roofline.btp: the same share as ntt_roofline.ct (each residue read
and written once, at the H100's HBM bandwidth, over the CUDA-event time of
the ring's transform entries), in the bootstrap's cells."""

from hebench.peaks import HBM_BYTES_PER_S


def read(r):
    t = r.ntt
    if not t or t["ms"] <= 0:
        return None
    return t["bytes"] / HBM_BYTES_PER_S * 1e3 / t["ms"] * 100
