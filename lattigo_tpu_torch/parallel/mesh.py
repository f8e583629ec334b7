"""The (dp, limb) mesh over ``torch.distributed``, and ciphertext sharding.

Counterpart of :mod:`lattigo_tpu.parallel.mesh`. A JAX ``Mesh`` names the
devices of one program, and XLA inserts the collectives that a sharded
program needs. Here every rank is a process of its own: a :class:`Mesh`
holds this rank's coordinates, one process group per mesh axis (the ranks
that differ from this one along that axis only) and the rank's device,
and its exchange helpers are the collectives, written out:

* :meth:`Mesh.all_gather` concatenates every rank's tensor of an axis
  group along a tensor axis (sizes may differ between ranks);
* :meth:`Mesh.exchange` swaps a tensor with one partner of the group
  (``batch_isend_irecv``), the counterpart of ``lax.ppermute``;
* :meth:`Mesh.broadcast` sends one rank's tensor to its group.

Gloo exchanges CPU tensors only (``broadcast`` and ``all_reduce`` aside).
So when ranks of a gloo world hold CUDA tensors, as ranks that share one
card do, each helper copies the tensor to the host, exchanges it and
copies the result back, and counts the bytes it staged. NCCL (one card a
rank) exchanges CUDA tensors directly. ``Mesh.stats`` counts the bytes
received (``gathered``, ``swapped``, ``broadcast``) and staged.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from lattigo_tpu_torch.device import resolve_device


def _mesh_device(device, backend: str, rank: int, world: int) -> torch.device:
    """The rank's device: ``cpu``; under NCCL ``cuda:rank`` (one card a
    rank, else it raises); under gloo ``cuda:(rank mod cards)``, so ranks
    beyond the card count share a card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    cards = torch.cuda.device_count()
    if backend == "nccl" and cards < world:
        raise RuntimeError(f"NCCL takes one card a rank: {world} ranks, "
                           f"{cards} cards (ranks that share a card use gloo)")
    dev = torch.device("cuda", rank % cards)
    torch.cuda.set_device(dev)
    return dev


class Mesh:
    """A named device mesh over the initialised world, row-major as
    ``np.asarray(devices).reshape(shape)``: rank r sits at the coordinates
    of r in that array.

    ``shape`` maps each axis name to its size, ``coords`` this rank's
    coordinates, ``groups[axis]`` the ranks of its axis group (global
    ranks, in axis order) and ``device`` the rank's device."""

    def __init__(self, axes: dict[str, int], device=None):
        dev = resolve_device(device)
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised "
                               "(see lattigo_tpu_torch.parallel.launch)")
        world, rank = dist.get_world_size(), dist.get_rank()
        names, sizes = tuple(axes), tuple(int(s) for s in axes.values())
        if math.prod(sizes) != world:
            raise ValueError(f"mesh {dict(axes)} != {world} ranks")
        self.backend = dist.get_backend()
        self.device = _mesh_device(dev, self.backend, rank, world)
        self.axis_names = names
        self.shape = dict(zip(names, sizes))
        self.rank = rank
        strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
        self.coords = {a: rank // st % sz for a, st, sz in zip(names, strides, sizes)}
        self.groups: dict[str, list[int]] = {}
        self._pg = {}
        for i, axis in enumerate(names):
            # every rank creates every group, in the same order
            for base in range(world):
                if base // strides[i] % sizes[i]:
                    continue                    # not the group's first rank
                ranks = [base + k * strides[i] for k in range(sizes[i])]
                if sizes[i] == world:
                    pg = dist.group.WORLD
                elif sizes[i] > 1:
                    pg = dist.new_group(ranks)
                else:
                    pg = None
                if rank in ranks:
                    self.groups[axis], self._pg[axis] = ranks, pg
        #: gloo with CUDA tensors: exchanges go through host copies
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.stats = {"gathered": 0, "swapped": 0, "broadcast": 0, "staged": 0}

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = 0

    # -- exchanges ----------------------------------------------------------

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor as the backend takes it (a host copy under staging)."""
        if self.staged and x.device.type == "cuda":
            self.stats["staged"] += x.numel() * x.element_size()
            return x.cpu()
        return x.contiguous()

    def _back(self, x: torch.Tensor) -> torch.Tensor:
        if x.device != self.device:
            self.stats["staged"] += x.numel() * x.element_size()
            return x.to(self.device)
        return x

    def all_gather(self, x: torch.Tensor, axis: str, dim: int,
                   sizes: list[int] | None = None) -> torch.Tensor:
        """Concatenate the group's tensors along ``dim``, in axis order.
        The tensors agree but for ``dim``; its sizes are exchanged first
        unless ``sizes`` (one a rank of the group) is given."""
        ranks = self.groups[axis]
        if len(ranks) == 1:
            return x
        dim = dim % x.dim()
        w = self._out(x)
        if sizes is None:
            n = torch.tensor([x.shape[dim]], dtype=torch.int64, device=w.device)
            ns = [torch.empty_like(n) for _ in ranks]
            dist.all_gather(ns, n, group=self._pg[axis])
            sizes = [int(v) for v in ns]
        top = max(sizes)
        if w.shape[dim] < top:
            pad = list(w.shape)
            pad[dim] = top - w.shape[dim]
            w = torch.cat([w, w.new_zeros(pad)], dim=dim)
        parts = [torch.empty_like(w) for _ in ranks]
        dist.all_gather(parts, w, group=self._pg[axis])
        me = ranks.index(self.rank)
        out = torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim=dim)
        self.stats["gathered"] += sum(p.narrow(dim, 0, s).numel() * p.element_size()
                                      for i, (p, s) in enumerate(zip(parts, sizes))
                                      if i != me)
        return self._back(out)

    def exchange(self, x: torch.Tensor, axis: str, partner: int) -> torch.Tensor:
        """Send x to the group's rank at axis coordinate ``partner`` and
        receive its tensor of the same shape (a pairwise swap)."""
        peer = self.groups[axis][partner]
        w = self._out(x)
        buf = torch.empty_like(w)
        ops = [dist.P2POp(dist.isend, w, peer, self._pg[axis]),
               dist.P2POp(dist.irecv, buf, peer, self._pg[axis])]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.stats["swapped"] += buf.numel() * buf.element_size()
        return self._back(buf)

    def broadcast(self, x: torch.Tensor, axis: str, src: int) -> torch.Tensor:
        """The group's rank at axis coordinate ``src`` sends x; every rank
        of the group returns it (x gives the shape on the others)."""
        ranks = self.groups[axis]
        if len(ranks) == 1:
            return x
        w = self._out(x)
        dist.broadcast(w, src=ranks[src], group=self._pg[axis])
        if ranks[src] != self.rank:
            self.stats["broadcast"] += w.numel() * w.element_size()
        return self._back(w)

    def all_gather_object(self, obj, axis: str) -> list:
        """Every rank's picklable ``obj`` of the group, in axis order
        (tensors in it should be on the host)."""
        ranks = self.groups[axis]
        if len(ranks) == 1:
            return [obj]
        out = [None] * len(ranks)
        dist.all_gather_object(out, obj, group=self._pg[axis])
        return out


def make_mesh(dp: int | None = None, limb: int = 1, *, backend: str | None = None,
              device=None) -> Mesh:
    """The (dp, limb) mesh over the initialised world (``dp`` defaults to
    world / limb); ``dp * limb`` must equal the world size. ``device``
    follows :func:`lattigo_tpu_torch.device.resolve_device`: none given and
    no CUDA raises. ``backend``, when given, must be the world's."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised "
                           "(see lattigo_tpu_torch.parallel.launch)")
    world = dist.get_world_size()
    if dp is None:
        dp = world // limb
    assert dp * limb == world, f"mesh {dp}x{limb} != {world} ranks"
    if backend is not None and backend != dist.get_backend():
        raise ValueError(f"backend {backend!r}: the world runs "
                         f"{dist.get_backend()!r}")
    return Mesh({"dp": dp, "limb": limb}, dev)


def batch_sharding(mesh: Mesh, ndim: int, limb_axis: bool = False,
                   dp_axis: bool = True) -> tuple:
    """Which mesh axis splits each tensor axis of a ciphertext value of
    rank ``ndim`` ([batch, degree+1, L, N] for 4): the batch axis over
    ``dp`` (unless ``dp_axis`` is False: then every dp rank holds the whole
    batch, as ``P(None, ..., "limb", None)``), the limb axis (-2) over
    ``limb`` when ``limb_axis`` is set and the limb axis has more than one
    rank; None elsewhere."""
    spec = [None] * ndim
    if dp_axis:
        spec[0] = "dp"
    if limb_axis and mesh.shape["limb"] > 1:
        spec[-2] = "limb"
    return tuple(spec)


def _split(size: int, parts: int, what: str) -> int:
    if size % parts:
        raise ValueError(f"{what} of size {size} does not divide over {parts} ranks")
    return size // parts


def shard_ciphertext(ct, mesh: Mesh, limb_axis: bool = False,
                     dp_axis: bool = True):
    """This rank's local ciphertext of a global one: its rows of the batch
    axis and, with ``limb_axis``, its contiguous share of the limbs
    (:func:`batch_sharding`). An axis that its mesh axis does not divide
    raises. The local ciphertext's ``level`` is that of its own limbs."""
    v = ct.value
    for axis, name in enumerate(batch_sharding(mesh, v.dim(), limb_axis, dp_axis)):
        if name is None:
            continue
        k = _split(v.shape[axis], mesh.shape[name], f"axis {axis} ({name})")
        v = v.narrow(axis, mesh.coords[name] * k, k)
    return ct.replace(value=v.contiguous().to(mesh.device))


def gather_ciphertext(ct, mesh: Mesh, limb_axis: bool = False,
                      dp_axis: bool = True):
    """The global ciphertext, on every rank, from each rank's local one
    (the counterpart of reading a sharded ``jax.Array`` back): limbs
    gathered over ``limb`` when ``limb_axis`` is set (each rank's limb
    count may differ, as after a rescale), then rows over ``dp`` unless
    ``dp_axis`` is False."""
    v = ct.value
    if limb_axis:
        v = mesh.all_gather(v, "limb", dim=-2)
    if dp_axis:
        v = mesh.all_gather(v, "dp", dim=0)
    return ct.replace(value=v)
