"""dft_ms: device ms a ciphertext in the homomorphic DFTs, CoeffsToSlots
("pre" to "c2s im") plus SlotsToCoeffs ("mod1 im" to "out")."""


def read(r):
    if "c2s" not in r.span_ms or not r.ct:
        return None
    return (r.span_ms["c2s"] + r.span_ms.get("s2c", 0.0)) / r.ct
