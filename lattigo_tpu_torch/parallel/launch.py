"""Run a function of this package on a world of n ranks.

The counterpart of the JAX package's virtual device mesh (its tests give
XLA 8 CPU devices in one process): here each rank is a process, spawned
with ``torch.multiprocessing`` (start method "spawn"), joined through a
``file://`` rendezvous in a fresh temporary directory (no TCP port, so
worlds that run side by side do not collide).

* The target lives in ``lattigo_tpu_torch``: a spawned rank re-imports the
  target's module, and nothing outside the package is imported there.
* The backend is the caller's, or follows from the device and the card
  count: NCCL for CUDA ranks that have a card each, gloo for CPU ranks and
  for ranks that share one card. It never changes after a failure.
* CPU ranks run torch on one thread each.
* A rank's exception fails the call with that rank's traceback
  (``torch.multiprocessing.ProcessRaisedException``); the other ranks are
  stopped. No rank returns after an error.

``run(target, world, device, *args)`` calls ``target(device, *args)`` on
every rank and returns the ranks' results, in rank order (each saved with
``torch.save``, so tensors in them should be on the host).
"""

from __future__ import annotations

import datetime
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lattigo_tpu_torch.device import resolve_device

#: a collective that waits longer than this fails its rank
TIMEOUT_S = 900


def default_backend(device, world: int) -> str:
    """gloo on the CPU and for ranks that share a card, NCCL when every
    rank has a card of its own."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_main(rank: int, world: int, backend: str, device: str, tmp: str,
               target, args) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = target(device, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"result-{rank}.pt"))


def run(target, world: int, device=None, *args, backend: str | None = None) -> list:
    """``target(device, *args)`` on ``world`` ranks; their results in rank
    order. ``device`` follows :func:`lattigo_tpu_torch.device.resolve_device`
    (none and no CUDA raises); a CUDA device is passed as "cuda", and each
    rank takes its card from the mesh (:func:`.mesh.make_mesh`)."""
    mod = getattr(target, "__module__", "") or ""
    if not mod.startswith("lattigo_tpu_torch."):
        raise ValueError(f"the target must be a function of lattigo_tpu_torch, "
                         f"not of {mod!r}: a spawned rank imports its module")
    dev = resolve_device(device)
    backend = backend or default_backend(dev, world)
    dev_name = dev.type
    with tempfile.TemporaryDirectory(prefix="lattigo_tpu_torch_world_") as tmp:
        mp.spawn(_rank_main, args=(world, backend, dev_name, tmp, target, args),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"result-{r}.pt"), weights_only=False)
                for r in range(world)]


def world_info(device) -> dict:
    """A rank's view of its world: rank, world size, backend, device and
    the names of the modules it has loaded."""
    return dict(rank=dist.get_rank(), world=dist.get_world_size(),
                backend=dist.get_backend(), device=str(device),
                modules=sorted(sys.modules))
