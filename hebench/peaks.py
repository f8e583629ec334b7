"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit); a run records the card's own limit beside them."""

#: HBM3 bandwidth, bytes a second
HBM_BYTES_PER_S = 3.35e12
