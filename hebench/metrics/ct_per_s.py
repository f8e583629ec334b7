"""ct_per_s: ciphertexts completed over the whole window's time."""


def read(r):
    return r.ct / r.window_s
