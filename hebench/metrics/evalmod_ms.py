"""evalmod_ms: device ms a ciphertext in EvalMod (both halves), between
the bootstrap's "c2s im" and "mod1 im" stage marks (CUDA events)."""


def read(r):
    ms = r.span_ms.get("evalmod")
    return None if ms is None or not r.ct else ms / r.ct
