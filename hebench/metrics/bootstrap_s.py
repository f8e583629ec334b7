"""bootstrap_s: the window's time over the ciphertexts bootstrapped in it
(whole calls only)."""


def read(r):
    return r.window_s / r.ct
