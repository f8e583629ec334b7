"""The data-parallel scaling line: the counterpart of the JAX package's
``bench_scaling.py``, with its step, arguments and JSON line.

    python3 bench_scaling_torch.py [n_ranks] [batch] [--device cpu]

The step is the JAX script's: CKKS at logN 12, Q (45, 38, 38, 38), P
(45,), scale 2^38, a batch of encryptions of zero, ``rotate(rescale(
mul_relin(c, c)), 1)``. It runs once in this process on the whole batch,
then on ``n_ranks`` ranks (:func:`.launch.run`) of a dp × 1 mesh, the batch
sharded over dp. Two facts decide how such a batch scales over cards:

1. **No communication on the dp axis.** The JAX script counts collectives
   in the compiled HLO. Here every exchange goes through the
   :class:`~.mesh.Mesh`, which counts the bytes it moves (``Mesh.stats``);
   the line's ``collectives_on_dp_axis`` is that count over the step on
   every rank, after ``reset_stats``, and must be 0: each rank runs the
   ordinary evaluator on its rows.
2. **Bit-exactness under sharding.** The ranks' outputs, gathered over dp,
   equal the one-process output exactly (integer arithmetic).

The line also carries the wall-clock ratio t_1dev / t_Ndev (each the mean
of a few steps after a warm-up, host clock, ending in a synchronize; the
N-rank time is the slowest rank's, the ranks starting together). It is not
a scaling figure: ranks that share one card (gloo, as on a one-card
machine) or the CPU's cores add no compute, as the JAX script's virtual
CPU devices add none. Only ranks with a card each (NCCL) would measure
scaling.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from lattigo_tpu_torch import interop
from lattigo_tpu_torch.device import resolve_device
from lattigo_tpu_torch.parallel import launch
from lattigo_tpu_torch.parallel.dryrun import _check_same, _sync, keys_digest
from lattigo_tpu_torch.parallel.mesh import gather_ciphertext, make_mesh, shard_ciphertext

#: the JAX script's chain; ``log_n`` may be cut for tests
LOG_Q, LOG_P, LOG_SCALE = (45, 38, 38, 38), (45,), 38
REPS = 8


def setup(device, batch: int, log_n: int = 12):
    """Parameters, the evaluator (relinearization key and the Galois key
    of rotation 1, from seed 0) and a batch of ``batch`` encryptions of
    zero: (params, evaluator, ciphertext)."""
    from lattigo_tpu_torch import rlwe
    from lattigo_tpu_torch.schemes import ckks

    params = ckks.Parameters(ckks.ParametersLiteral(
        log_n=log_n, log_q=LOG_Q, log_p=LOG_P, log_default_scale=LOG_SCALE),
        device=device)
    gen = torch.Generator(device=params.ring_q.device).manual_seed(0)
    kg = rlwe.KeyGenerator(params)
    sk = kg.gen_secret_key(gen)
    rlk = kg.gen_relinearization_key(gen, sk)
    gks = kg.gen_galois_keys(gen, [params.galois_element(1)], sk)
    ev = ckks.Evaluator(params, rlwe.EvaluationKeySet(
        relinearization_key=rlk, galois_keys=gks))
    ct = rlwe.Encryptor(params, sk).encrypt_zero(gen, batch=(batch,))
    return params, ev, ct


def step(ev, value: torch.Tensor) -> torch.Tensor:
    """The JAX script's step on a ciphertext value [batch, 2, L, N]."""
    from lattigo_tpu_torch.rlwe.elements import Ciphertext
    c = Ciphertext(value=value, is_ntt=True, scale=ev.params.default_scale_fraction)
    c = ev.rotate(ev.rescale(ev.mul_relin(c, c)), 1)
    return c.value


def timed_s(fn, device, reps: int = REPS, barrier: bool = False) -> float:
    """Mean seconds of fn() over ``reps`` runs after one warm-up, on the
    host clock, ending in a synchronize (after a barrier of the world when
    ``barrier``, so that the ranks start together)."""
    fn()
    _sync(device)
    if barrier:
        dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps


def scaling_rank(device, literal_json: str, rlk_rows, galois_rows: dict, value,
                 reps: int = REPS) -> dict:
    """One rank of the dp × 1 mesh: the global batch ``value`` (numpy
    uint64 [batch, 2, L, N]) sharded over dp, the step on this rank's rows
    with the mesh's byte counts read over it, its time, both kernels'
    launches over the steps, and (rank 0) the output gathered over dp."""
    from lattigo_tpu_torch.ring import ntt_mxu, ntt_pallas
    from lattigo_tpu_torch.schemes import ckks

    mesh = make_mesh(limb=1, device=device)
    dev = mesh.device
    params = ckks.Parameters(interop.parameters_literal_from_json(literal_json), device=dev)
    ev = ckks.Evaluator(params, interop.evaluation_key_set_from_numpy(
        dev, rlk=rlk_rows, galois_keys=galois_rows))
    kd = keys_digest(ev.evk)
    _check_same(mesh, kd, "keys")
    local = shard_ciphertext(interop.ciphertext_from_numpy(value, dev), mesh)
    ntt_mxu.reset_launches()
    ntt_pallas.reset_launches()
    mesh.reset_stats()
    out = step(ev, local.value)
    _sync(dev)
    stats = dict(mesh.stats)
    t = timed_s(lambda: step(ev, local.value), dev, reps, barrier=True)
    launches = {"ntt_mxu": dict(ntt_mxu.LAUNCHES), "ntt_pallas": dict(ntt_pallas.LAUNCHES)}
    full = gather_ciphertext(local.replace(value=out), mesh)
    res = dict(rank=mesh.rank, dp_bytes=sum(stats.values()), stats=stats, t_s=t,
               local_shape=tuple(local.value.shape), keys_digest=kd,
               backend=mesh.backend, engine=params.ring_q.ntt_engine, launches=launches)
    if mesh.rank == 0:
        res["output"] = interop.to_numpy(full.value)
    return res


def run(n_ranks: int = 4, batch: int = 16, device=None, log_n: int = 12,
        reps: int = REPS) -> dict:
    """The step in one process and on ``n_ranks`` ranks; returns the JSON
    line's fields (``bench_scaling.py``'s keys) after its two checks."""
    device = resolve_device(device)
    if batch % n_ranks:
        raise ValueError(f"a batch of {batch} does not divide over {n_ranks} ranks")
    params, ev, ct = setup(device, batch, log_n)
    r1 = step(ev, ct.value)
    t1 = timed_s(lambda: step(ev, ct.value), device, reps)
    evk = ev.evk
    ranks = launch.run(
        scaling_rank, n_ranks, device, params.literal.to_json(),
        interop.qp_to_numpy(evk.relinearization_key.gadget.value),
        {g: interop.qp_to_numpy(k.gadget.value) for g, k in evk.galois_keys.items()},
        interop.to_numpy(ct.value), reps)
    if {r["keys_digest"] for r in ranks} != {keys_digest(evk)}:
        raise RuntimeError("the ranks' keys differ from this process's")
    n_coll = sum(r["dp_bytes"] for r in ranks)
    bit_exact = bool(np.array_equal(interop.to_numpy(r1), ranks[0]["output"]))
    t_n = max(r["t_s"] for r in ranks)
    line = {
        "metric": "dp_scaling_batched_ckks_eval",
        "n_devices": n_ranks,
        "batch": batch,
        "collectives_on_dp_axis": n_coll,
        "bit_exact": bit_exact,
        "t_1dev_s": round(t1, 6),
        "t_Ndev_s": round(t_n, 6),
        "wallclock_ratio_shared_cores": round(t1 / t_n, 3) if t_n > 0 else 0.0,
    }
    print(json.dumps(line), flush=True)
    # the JAX script's two asserts, kept under ``python -O`` too
    if n_coll != 0:
        raise AssertionError("the dp axis must run exchange-free")
    if not bit_exact:
        raise AssertionError("the sharded result must equal the one-process result")
    return dict(line, backend=ranks[0]["backend"], log_n=params.log_n,
                local_shape=ranks[0]["local_shape"], engine=params.ring_q.ntt_engine,
                rank_engines=sorted({r["engine"] for r in ranks}),
                rank_launches=[r["launches"] for r in ranks])


def main(argv=None) -> dict:
    """``bench_scaling.py``'s command line, plus ``--device``."""
    ap = argparse.ArgumentParser(description="Data-parallel scaling of a batched "
                                             "CKKS step over ranks.")
    ap.add_argument("n_ranks", nargs="?", type=int, default=4)
    ap.add_argument("batch", nargs="?", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run there)")
    a = ap.parse_args(argv)
    return run(a.n_ranks, a.batch, a.device)
