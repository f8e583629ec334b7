"""torch_ops_per_btp: aten ops dispatched a ciphertext over one request
after the traced window (a TorchDispatchMode, the total only). A run
counts them wherever a metric it reports sets ``NEEDS_OPS``."""

NEEDS_OPS = True


def read(r):
    return r.ops_per_ct
