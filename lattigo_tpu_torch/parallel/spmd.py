"""Rank-local programs of a sharded evaluator: the collectives written out.

In the JAX package a sharded step is one program: ``jax.jit`` with
``in_shardings`` over a ``Mesh`` lets XLA's partitioner run each op where
its data lies and insert the collectives. PyTorch has no partitioner that
reaches the port's int64 ops and kernels, so this module is that
partition, by hand, for the programs of the multichip dry run:

* **dp** (ciphertext batch): each rank runs the ordinary evaluator on its
  batch rows; the only communication is the final gather
  (:func:`.mesh.gather_ciphertext`): a batch bootstraps by the ordinary
  ``bootstrap`` on each rank's rows, and :func:`bootstrap_many` splits a
  list of (sparse, packed) ciphertexts over the dp ranks.
* **limb** (RNS limbs): :class:`LimbShardedEvaluator` runs every
  limb-local op (tensor product, NTTs, the gadget MAC against the rank's
  share of the key's Q and P limbs) on the rank's limbs only, through a
  :class:`~lattigo_tpu_torch.ring.ring.Ring` over its own moduli (so a
  kernel engine runs on each limb shard). The contractions over limbs
  gather what they read over the limb group: the key switch's ModUp (each
  rank computes y_i = x_i·(Q/q_i)^{-1} of its own limbs and gathers the
  others'), ModDown's P → Q (the P limbs' y_i likewise) and rescale's last
  limb (its owner transforms it and broadcasts it).

Q limbs of a ciphertext at level l are split into equal contiguous shares
over the limb group (l + 1 must divide, as ``jax.device_put`` requires),
the P limbs into contiguous shares as even as they go (a rank may hold
none). Every output is bit-equal to the same program on one process: each
op ends canonical, whatever limbs it ran on.
"""

from __future__ import annotations

import torch

from lattigo_tpu_torch.ring import automorphism as auto_mod, modops
from lattigo_tpu_torch.ring.basis_extension import ModUpConstants, mod_up_contract
from lattigo_tpu_torch.ring.ring import Ring, u64_tensor
from lattigo_tpu_torch.ring.ringqp import QPPoly
from lattigo_tpu_torch.rlwe.elements import Ciphertext


def limb_share(lq: int, parts: int, j: int) -> tuple[int, int]:
    """Rank j's contiguous share [lo, hi) of lq limbs split evenly."""
    if lq % parts:
        raise ValueError(f"{lq} limbs do not divide over {parts} ranks")
    k = lq // parts
    return j * k, (j + 1) * k


def p_share(lp: int, parts: int, j: int) -> tuple[int, int]:
    """Rank j's contiguous share of the P limbs, as even as they go (the
    first lp mod parts ranks hold one more)."""
    base, extra = divmod(lp, parts)
    lo = j * base + min(j, extra)
    return lo, lo + base + (j < extra)


class LimbShardedEvaluator:
    """A scheme evaluator's key switching, BGV tensoring and rescaling on
    this rank's RNS limbs, over the mesh axis ``axis`` (default "limb").

    ``ev`` is the ordinary evaluator (its parameters and keys, the same on
    every rank). Methods take and return this rank's local ciphertexts
    (rows as they come, limbs as :func:`limb_share` splits them) with the
    global ``level`` given beside them."""

    def __init__(self, ev, mesh, axis: str = "limb"):
        self.ev = ev
        self.params = ev.params
        self.mesh = mesh
        self.axis = axis
        self.parts = mesh.shape[axis]
        self.j = mesh.coords[axis]
        self._rings: dict = {}
        self._consts: dict = {}

    # -- this rank's limbs ------------------------------------------------------

    def q_share(self, lq: int) -> tuple[int, int]:
        return limb_share(lq, self.parts, self.j)

    def p_share(self) -> tuple[int, int]:
        return p_share(len(self.params.p_moduli), self.parts, self.j)

    def p_sizes(self) -> list[int]:
        lp = len(self.params.p_moduli)
        return [b - a for a, b in (p_share(lp, self.parts, i) for i in range(self.parts))]

    def ring(self, moduli: tuple[int, ...]) -> Ring | None:
        """The ring over these moduli on the rank's device (None if none)."""
        if not moduli:
            return None
        if moduli not in self._rings:
            p = self.params
            self._rings[moduli] = Ring(p.n, list(moduli), p.ring_type, self.mesh.device)
        return self._rings[moduli]

    def consts(self, src: tuple[int, ...], dst: tuple[int, ...]) -> ModUpConstants:
        key = (src, dst)
        if key not in self._consts:
            self._consts[key] = ModUpConstants(list(src), list(dst), self.mesh.device)
        return self._consts[key]

    def _tables(self, lo: int, hi: int, chain: str = "q"):
        r = self.params.ring_q if chain == "q" else self.params.ring_p
        return r.q[lo:hi], r.qinv[lo:hi], r.bred_hi[lo:hi]

    @staticmethod
    def _mred_src(x, c: ModUpConstants, a: int, b: int):
        """y_i = x_i·(Q/q_i)^{-1} of source limbs a..b of ``c``."""
        return modops.mred(x, c.qhatinv[a:b], c.src_q[a:b], c.src_qinv[a:b],
                           c.src_small)

    # -- key switching ------------------------------------------------------------

    def decompose(self, c1, lq: int) -> QPPoly:
        """This rank's limbs of the RNS gadget digits of c1 (NTT, the rank's
        lq/parts limbs): q [..., beta, my Q, N], p [..., beta, my P, N]."""
        p, dec = self.params, self.params.decomposer
        lo, hi = self.q_share(lq)
        plo, phi = self.p_share()
        qm, pm = tuple(p.q_moduli), tuple(p.p_moduli)
        rq = self.ring(qm[lo:hi])
        coeff = rq.intt(c1)                                 # limb-local
        beta = dec.num_digits(lq - 1)
        dst = qm[lo:hi] + pm[plo:phi]
        spans = [dec.digit_range(lq - 1, d) for d in range(beta)]
        ys = []
        for dlo, dhi in spans:                              # own limbs' y_i
            a, b = max(lo, dlo), min(hi, dhi)
            if a < b:
                c = self.consts(qm[dlo:dhi], dst)
                ys.append(self._mred_src(coeff[..., a - lo:b - lo, :], c,
                                         a - dlo, b - dlo))
        y = self.mesh.all_gather(torch.cat(ys, dim=-2), self.axis, dim=-2,
                                 sizes=[hi - lo] * self.parts)
        q_ = torch.cat([self._tables(lo, hi)[0], self._tables(plo, phi, "p")[0]])
        qinv_ = torch.cat([self._tables(lo, hi)[1], self._tables(plo, phi, "p")[1]])
        bhi_ = torch.cat([self._tables(lo, hi)[2], self._tables(plo, phi, "p")[2]])
        yq, yp = [], []
        for dlo, dhi in spans:                              # contraction onto own limbs
            ext = mod_up_contract(y[..., dlo:dhi, :], self.consts(qm[dlo:dhi], dst),
                                  q_, qinv_, bhi_, centered=True)
            a, b = max(lo, dlo), min(hi, dhi)
            if a < b:                                       # own digit limbs pass through
                ext[..., a - lo:b - lo, :] = coeff[..., a - lo:b - lo, :]
            yq.append(ext[..., :hi - lo, :])
            yp.append(ext[..., hi - lo:, :])
        dq = rq.ntt(torch.stack(yq, dim=-3))
        dp_ = torch.stack(yp, dim=-3)
        if phi > plo:
            dp_ = self.ring(pm[plo:phi]).ntt(dp_)
        return QPPoly(dq, dp_)

    def mod_down(self, acc_q, acc_p, lq: int):
        """round(x/P) on this rank's Q limbs from its Q and P limbs (NTT):
        the P limbs' y_i are gathered over the group."""
        p = self.params
        lo, hi = self.q_share(lq)
        plo, phi = self.p_share()
        qm, pm = tuple(p.q_moduli), tuple(p.p_moduli)
        c = self.consts(pm, qm[lo:hi])
        y = acc_p
        if phi > plo:
            y = self._mred_src(self.ring(pm[plo:phi]).intt(acc_p), c, plo, phi)
        y = self.mesh.all_gather(y, self.axis, dim=-2, sizes=self.p_sizes())
        q, qinv, bhi = self._tables(lo, hi)
        rq = self.ring(qm[lo:hi])
        lift = rq.ntt(mod_up_contract(y, c, q, qinv, bhi, centered=True))
        diff = modops.sub_mod(acc_q, lift, q)
        return modops.mred(diff, p.basis_extender.pinv_q[lo:hi], q, qinv,
                           p.ring_q.small)

    def gadget_product_hoisted(self, digits: QPPoly, gadget, lq: int):
        """The gadget MAC against the rank's share of the key's Q and P
        limbs, then ModDown: [..., 2, my Q, N]."""
        p = self.params
        if gadget.base2:
            raise NotImplementedError("the base-2 gadget is not limb-sharded")
        lo, hi = self.q_share(lq)
        plo, phi = self.p_share()
        beta = digits.q.shape[-3]
        evq, evp = gadget.value.q, gadget.value.p
        if evq.shape[-2] < lq or evq.shape[-4] < beta:
            raise ValueError(f"evaluation key generated at level "
                             f"{evq.shape[-2] - 1} used at level {lq - 1}")
        margin = modops.margin_for(max(max(p.q_moduli[:lq]), max(p.p_moduli)))

        def mac(d, ev, q, qinv, bhi, small):
            t = modops.mred_lazy(d[..., :, None, :, :], ev, q, qinv, small)
            acc = modops.lazy_tree_sum(torch.movedim(t, -4, 0), q, bhi, margin)
            return modops.bred_add(acc, q, bhi)

        acc_q = mac(digits.q, evq[:beta, :, lo:hi, :], *self._tables(lo, hi),
                    p.ring_q.small)
        if phi > plo:
            acc_p = mac(digits.p, evp[:beta, :, plo:phi, :], *self._tables(plo, phi, "p"),
                        p.ring_p.small)
        else:
            acc_p = acc_q.new_zeros(acc_q.shape[:-2] + (0, acc_q.shape[-1]))
        return self.mod_down(acc_q, acc_p, lq)

    def gadget_product(self, c, gadget, lq: int):
        return self.gadget_product_hoisted(self.decompose(c, lq), gadget, lq)

    def relinearize(self, v, lq: int):
        """Degree-d → degree-1 by iterated key switching (v NTT, own limbs)."""
        rlk = self.ev.evk.relinearization_key
        if rlk is None:
            raise ValueError("no relinearization key")
        lo, hi = self.q_share(lq)
        q = self._tables(lo, hi)[0]
        while v.shape[-3] > 2:
            d = self.gadget_product(v[..., -1, :, :], rlk.gadget, lq)
            v = torch.stack([modops.add_mod(v[..., 0, :, :], d[..., 0, :, :], q),
                             modops.add_mod(v[..., 1, :, :], d[..., 1, :, :], q)]
                            + [v[..., i, :, :] for i in range(2, v.shape[-3] - 1)],
                            dim=-3)
        return v

    # -- BGV tensoring and rescaling ----------------------------------------------

    def mul_relin(self, ct0: Ciphertext, ct1: Ciphertext, level: int) -> Ciphertext:
        """BGV ct0 ⊗ ct1 (·T), relinearized; both at ``level``."""
        p = self.params
        lo, hi = self.q_share(level + 1)
        q, qinv, _ = self._tables(lo, hi)
        sm = p.ring_q.small
        tm2 = p.t_mont2[lo:hi]
        v = self.ev._tensor(ct0.value, ct1.value, q, qinv, sm,
                            lambda a: modops.mred(a, tm2, q, qinv, sm))
        return Ciphertext(value=self.relinearize(v, level + 1), is_ntt=True,
                          scale=p.scale_mul(ct0.scale, ct1.scale))

    def rescale(self, ct: Ciphertext, level: int) -> Ciphertext:
        """BGV rescale of an NTT ciphertext at ``level`` (split evenly):
        the last limb's owner transforms it back and broadcasts it; every
        rank divides its own limbs below ``level``; the owner drops it."""
        p = self.params
        if level < 1:
            raise ValueError("cannot rescale at level 0")
        lo, hi = self.q_share(level + 1)
        owner = self.parts - 1
        rq = self.ring(tuple(p.q_moduli[lo:hi]))
        x = ct.value
        q_last = p.q_moduli[level]
        half = q_last >> 1
        if self.j == owner:
            i = level - lo
            last = rq.intt_single(i, x[..., i:i + 1, :].contiguous())[..., 0, :]
            last = modops.cred(last + half, q_last)
        else:
            last = x.new_empty(x.shape[:-2] + x.shape[-1:])
        last = self.mesh.broadcast(last, self.axis, owner)
        nb = min(hi, level) - lo
        if nb == 0:
            out = x[..., :0, :]
        else:
            q, qinv, bhi = self._tables(lo, lo + nb)
            half_i = u64_tensor([half % m for m in p.q_moduli[lo:lo + nb]],
                                x.device, (nb, 1))
            lifted = modops.sub_mod(modops.bred_add(last[..., None, :], q, bhi),
                                    half_i, q)
            lifted = rq.ntt(lifted, level=nb - 1)
            diff = modops.sub_mod(x[..., :nb, :], lifted, q)
            out = modops.mred(diff, p.ring_q.rescale_constants[level, lo:lo + nb],
                              q, qinv, p.ring_q.small)
        return ct.replace(value=out, scale=p.scale_div_q(ct.scale, level))

    # -- rotations ------------------------------------------------------------------

    def rotate_columns_hoisted(self, ct: Ciphertext, level: int,
                               ks: list[int]) -> dict[int, Ciphertext]:
        """Rotations by every k in ks from ONE decomposition of c1."""
        p = self.params
        lq = level + 1
        lo, hi = self.q_share(lq)
        q = self._tables(lo, hi)[0]
        digits = self.decompose(ct.value[..., 1, :, :], lq)
        out = {}
        for k in ks:
            g = p.galois_element(k)
            if g == 1:
                out[k] = ct
                continue
            d = self.gadget_product_hoisted(digits, self.ev.evk.galois_key(g).gadget, lq)
            d0 = modops.add_mod(d[..., 0, :, :], ct.value[..., 0, :, :], q)
            v = torch.stack([d0, d[..., 1, :, :]], dim=-3)
            out[k] = ct.replace(value=auto_mod.automorphism_ntt(v, p.n, g, p.ring_type))
        return out


# -- dp programs ----------------------------------------------------------------------

def bootstrap_many(btp, cts: list[Ciphertext], mesh, keys=None,
                   log_slots: int | None = None, axis: str = "dp") -> list[Ciphertext]:
    """:meth:`BootstrappingEvaluator.bootstrap_many` with its bootstraps
    split over ``axis``: sparse ciphertexts are packed in groups of
    2^(log_max_slots − log_slots) (full ones one a group), group i runs on
    the rank at coordinate i mod size, and every rank returns all outputs
    in order."""
    p = btp.params
    per = 1
    if log_slots is not None and (1 << log_slots) < p.max_slots:
        per = 1 << (p.max_slots.bit_length() - 1 - log_slots)
    size, j = mesh.shape[axis], mesh.coords[axis]
    mine = []
    for i, lo in enumerate(range(0, len(cts), per)):
        if i % size == j:
            outs = btp.bootstrap_many(cts[lo:lo + per], keys, log_slots)
            mine.append((lo, [(o.value.cpu(), o.is_ntt, o.is_montgomery, o.scale)
                              for o in outs]))
    out: list = [None] * len(cts)
    for part in mesh.all_gather_object(mine, axis):
        for lo, outs in part:
            for k, (v, is_ntt, is_mont, scale) in enumerate(outs):
                out[lo + k] = Ciphertext(value=v.to(mesh.device), is_ntt=is_ntt,
                                         is_montgomery=is_mont, scale=scale)
    return out
