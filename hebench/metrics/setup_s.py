"""setup_s: process start to the first timed request: imports, the
program's parameters and keys, the inputs, one warm request and any
kernel build it triggers."""


def read(r):
    return r.setup_s
