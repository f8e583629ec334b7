"""The multichip dry run (``lattigo_tpu_torch.parallel.dryrun``, the
counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``) on 4 gloo
ranks on the CPU: every part passes its own checks inside the ranks (the
dp × limb BGV step, the sp-sharded product and the limb-sharded hoisted
rotations bit-equal to one process, every bootstrap ≥ 6 bits), the mesh
keeps its contracts, and the dp-sharded bootstraps are bit-equal to the
same bootstraps in one process."""

import numpy as np
import pytest
import torch

from lattigo_tpu_torch import interop
from lattigo_tpu_torch.parallel import dryrun


@pytest.fixture(scope="module")
def run():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r0 = dryrun.dryrun_multichip(4, device="cpu")
        s = dryrun.bootstrap_setup("cpu", r0["mesh"]["dp"])
        one = s["btp"].bootstrap(s["ct"])
        many = s["btp"].bootstrap_many(s["cts"], log_slots=s["log_slots"])
    finally:
        torch.set_num_threads(n)
    return r0, one, many


def test_dryrun_passes(run):
    r0, _, _ = run
    assert r0["mesh"] == {"dp": 2, "limb": 2}
    assert r0["backend"] == "gloo"
    assert all(r0["mesh_checks"].values()), r0["mesh_checks"]
    assert all(r0["sp"]["checks"].values())
    assert r0["out_shape"] == (4, 2, 3, 256)
    assert min(r0["bootstrap_bits"] + r0["packed_bits"]) >= dryrun.MIN_BITS
    assert len(r0["packed_bits"]) == 2


def test_dp_bootstrap_matches_one_process(run):
    r0, one, _ = run
    np.testing.assert_array_equal(r0["bootstrap"], interop.to_numpy(one.value))


def test_packed_pair_matches_one_process(run):
    r0, _, many = run
    assert len(r0["packed"]) == len(many) == 2
    for got, want in zip(r0["packed"], many):
        np.testing.assert_array_equal(got, interop.to_numpy(want.value))
