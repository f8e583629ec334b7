"""The check's control: the program with its residue products computed in
float64, the nearest precision below the exact 64-bit integer arithmetic
that the configurations' RNS chains state (a product of two residues of
the chains' 26-56-bit primes has up to 112 bits; float64 keeps 53).
Moving the products to the FP64 units is the step that tempts a GPU port;
the check has to fail it.

Every Montgomery product of the program's torch layer (``modops.mred`` and
``modops.mred_lazy``, which the tensor products, the key-switch products
and the rescale take) becomes: a·b rounded to float64, reduced mod q in
float64, then multiplied by 2^-64 exactly. The transforms are left as they
are.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float64_products():
    from lattigo_tpu_torch.ring import modops

    exact, exact_lazy = modops.mred, modops.mred_lazy

    def mred(a, b, q, qinv, small=None):
        qf = q.to(torch.float64)
        x = torch.fmod(a.to(torch.float64) * b.to(torch.float64), qf)
        x = torch.remainder(torch.round(x).to(torch.int64), q)
        return exact(x, torch.ones_like(x), q, qinv, small)

    modops.mred, modops.mred_lazy = mred, mred
    try:
        yield
    finally:
        modops.mred, modops.mred_lazy = exact, exact_lazy
