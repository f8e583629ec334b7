"""Slot-space linear transformations by the hoisted BSGS diagonal method.

Counterpart of :mod:`lattigo_tpu.circuits.lintrans`. A linear
transformation is a set of non-zero diagonals of the slot-space matrix;
evaluation is

    out = Σ_j σ_{N1·j}( Σ_i  pt[N1·j+i] ⊙ σ_i(ct) )

with the baby rotations σ_i hoisted (one gadget decomposition of c1 for all
of them) and the inner sums accumulated in the extended basis R_QP, so one
ModDown is paid per giant step. The giant steps run batched on a leading
axis. Diagonal plaintexts are stored in NTT + Montgomery form over QP, with
the giant step's pre-rotation baked in at encoding time.

Lazy sums flush every ``margin`` terms with the margin derived from 2^63
(:func:`modops.margin_for`) where the reference derives it from 2^64; the
two fold points differ only for primes above 2^59, and every sum ends in a
full reduction to [0, q), so the results are the same integers.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Any, Callable

import numpy as np
import torch

from lattigo_tpu_torch.ring import automorphism as auto_mod, modops
from lattigo_tpu_torch.ring.ring import u64_tensor
from lattigo_tpu_torch.ring.ringqp import QPPoly
from lattigo_tpu_torch.rlwe.elements import Ciphertext
from lattigo_tpu_torch.rlwe.evaluator import Evaluator as RlweEvaluator
from lattigo_tpu_torch.trace import span


def bsgs_split(diags: list[int], slots: int, log_bsgs_ratio: int = 0) -> int:
    """The baby-step width N1: the power of two that minimises the key
    switches (#babies − 1) + 2^-ratio·(#giants − 1). It handles STRIDED
    diagonal sets: 16 diagonals of stride 256 split 4×4 instead of
    degenerating into 16 giant steps."""
    n = len(diags)
    if n <= 1:
        return 1
    best_n1, best_cost = 1, float("inf")
    w = 2.0 ** (-log_bsgs_ratio)
    n1 = 1
    while n1 <= slots:
        index = bsgs_index(diags, slots, n1)
        nb_babies = len({i for b in index.values() for i in b})
        nb_giants = len(index)
        cost = (nb_babies - 1) + w * (nb_giants - 1)
        if cost < best_cost:
            best_n1, best_cost = n1, cost
        n1 <<= 1
    return best_n1


def bsgs_index(diags: list[int], slots: int, n1: int) -> dict[int, list[int]]:
    """index[j] = sorted baby offsets i with diagonal j+i present (mod slots)."""
    index: dict[int, list[int]] = {}
    for k in diags:
        k = k % slots
        j = k - (k % n1)
        index.setdefault(j, []).append(k % n1)
    for j in index:
        index[j] = sorted(set(index[j]))
    return dict(sorted(index.items()))


@dataclass
class LinearTransformation:
    """Encoded linear transformation: vec[k] is diagonal k pre-rotated by
    its giant step, NTT + Montgomery over QP at level_q."""

    vec: dict[int, QPPoly]
    n1: int = 1
    level_q: int = 0
    scale: Any = 1
    slots: int = 0

    @property
    def index(self) -> dict[int, list[int]]:
        return bsgs_index(list(self.vec.keys()), self.slots, self.n1)

    def galois_elements(self, params) -> list[int]:
        """All Galois elements needed to evaluate (babies + giants)."""
        els = set()
        for j, babies in self.index.items():
            if j != 0:
                els.add(params.galois_element(j))
            for i in babies:
                if i != 0:
                    els.add(params.galois_element(i))
        return sorted(els)


def encode_linear_transformation(
    params,
    diagonals: dict[int, np.ndarray],
    encode_diag: Callable[[np.ndarray, int], QPPoly],
    level_q: int,
    scale: Any,
    slots: int,
    log_bsgs_ratio: int = 0,
    rotate_diag: Callable[[np.ndarray, int], np.ndarray] | None = None,
) -> LinearTransformation:
    """Encode diagonals with the giant-step pre-rotation baked in.

    ``encode_diag(vector, level_q)`` returns the NTT + Montgomery QP
    encoding of one (already rotated) diagonal; where it has an
    ``encode_batch(vectors, level_q)`` attribute, all diagonals are encoded
    in one call. ``rotate_diag(vec, j)`` applies the pre-rotation: the
    evaluator applies σ_j AFTER the inner product and σ_j rotates slots
    left by j, so the stored diagonal is rotated RIGHT by j. Default
    np.roll(d, +j); BGV rolls its two rows separately.
    """
    diags = sorted(k % slots for k in diagonals.keys())
    n1 = bsgs_split(diags, slots, log_bsgs_ratio)
    if rotate_diag is None:
        rotate_diag = lambda d, j: np.roll(d, j, axis=-1)
    ks, rots = [], []
    for k, d in diagonals.items():
        k = k % slots
        j = k - (k % n1)
        d = np.asarray(d)
        ks.append(k)
        rots.append(rotate_diag(d, j) if j else d)
    vec: dict[int, QPPoly] = {}
    batch = getattr(encode_diag, "encode_batch", None)
    if batch is not None:
        qp = batch(np.stack(rots), level_q)
        for i, k in enumerate(ks):
            vec[k] = QPPoly(qp.q[i], None if qp.p is None else qp.p[i])
    else:
        for k, rot in zip(ks, rots):
            vec[k] = encode_diag(rot, level_q)
    return LinearTransformation(vec=vec, n1=n1, level_q=level_q,
                                scale=scale, slots=slots)


# ---------------------------------------------------------------------------
# Scheme bindings
# ---------------------------------------------------------------------------

def _lift_signed_qp(params, x: torch.Tensor, level_q: int) -> QPPoly:
    """Residues of signed int64 coefficients x [..., N] (|x| < 2^63) over
    Q (limbs 0..level_q) and P, NTT + Montgomery."""
    def lift(ring, level):
        l = level + 1
        q, bhi = ring.q[:l], ring.bred_hi[:l]
        r = modops.bred_add(x.abs()[..., None, :], q, bhi)
        r = torch.where((x < 0)[..., None, :], modops.neg_mod(r, q), r)
        return ring.mform(ring.ntt(r, level), level)

    rp = params.ring_p
    return QPPoly(lift(params.ring_q, level_q),
                  None if rp is None else lift(rp, rp.max_level))


def lift_f64_qp(params, vals: np.ndarray, level_q: int) -> QPPoly:
    """Signed integral f64 coefficients [..., N] → NTT + Montgomery QPPoly.

    The magnitude (< 2^63, integral) converts to int64 exactly, and each
    limb reduces it on the device (the reference assembles the same u64 as
    hi·2^32 + lo on the host).
    """
    vals = np.rint(np.asarray(vals, dtype=np.float64))
    if not np.all(np.abs(vals) < 2.0 ** 63):
        raise ValueError("constant exceeds 63-bit magnitude")
    x = torch.from_numpy(vals.astype(np.int64)).to(params.ring_q.device)
    return _lift_signed_qp(params, x, level_q)


def lift_ints_qp(params, ints: np.ndarray, level_q: int) -> QPPoly:
    """Signed integer coefficients [..., N] (int64, or Python integers in
    an object array) → NTT + Montgomery QPPoly."""
    ints = np.asarray(ints)
    if ints.dtype != object:
        x = torch.from_numpy(ints.astype(np.int64)).to(params.ring_q.device)
        return _lift_signed_qp(params, x, level_q)

    def lift(ring, moduli, level):
        out = np.stack([np.mod(ints, q) for q in moduli], axis=-2)
        r = u64_tensor(out.astype(np.uint64), ring.device)
        return ring.mform(ring.ntt(r, level), level)

    rp = params.ring_p
    return QPPoly(lift(params.ring_q, params.q_moduli[: level_q + 1], level_q),
                  None if rp is None else lift(rp, params.p_moduli, rp.max_level))


def ckks_diag_encoder(params, encoder, scale) -> Callable[[np.ndarray, int], QPPoly]:
    """Diagonal encoder for CKKS: embed → ×scale → round → lift to QP, with
    ``encode_batch(vecs[D, slots], level_q)`` for a whole matrix at once."""
    def encode_batch(vecs: np.ndarray, level_q: int) -> QPPoly:
        coeffs = encoder.embed_to_coeffs(vecs) * float(scale)
        return lift_f64_qp(params, coeffs, level_q)

    def encode_diag(vec: np.ndarray, level_q: int) -> QPPoly:
        qp = encode_batch(np.asarray(vec)[None], level_q)
        return QPPoly(qp.q[0], None if qp.p is None else qp.p[0])

    encode_diag.encode_batch = encode_batch
    return encode_diag


def bgv_diag_encoder(params, encoder) -> Callable[[np.ndarray, int], QPPoly]:
    """Diagonal encoder for BGV: raw m ∈ R_T, centered lift (no T^{-1}):
    ct(m1·s·T^{-1})·m2 decrypts to m1m2·s·T^{-1}, plain-mul semantics with
    lt.scale = 1."""
    def encode_diag(vec: np.ndarray, level_q: int) -> QPPoly:
        coeffs_t = encoder.encode_ring_t(vec)[..., 0, :]
        centered = torch.where(coeffs_t > (params.t >> 1),
                               coeffs_t - params.t, coeffs_t)
        return _lift_signed_qp(params, centered, level_q)
    return encode_diag


def bgv_rotate_diag(vec: np.ndarray, j: int) -> np.ndarray:
    """Right-roll the 2 × N/2 BGV slot rows independently."""
    half = vec.shape[-1] // 2
    return np.concatenate(
        [np.roll(vec[..., :half], j, axis=-1),
         np.roll(vec[..., half:], j, axis=-1)], axis=-1)


def _pt_aligned(pt: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """pt [K, l, N] viewed as [K, 1.., l, N] against x [K, *batch, l, N]."""
    ext = (1,) * (x.dim() - pt.dim())
    return pt.reshape(pt.shape[:1] + ext + pt.shape[1:])


class LinTransEvaluator:
    """Hoisted BSGS evaluation over a scheme evaluator's Galois keys."""

    def __init__(self, rlwe_eval: RlweEvaluator):
        self.ev = rlwe_eval
        self.params = rlwe_eval.params

    def _pre_rotate(self, ct: Ciphertext, digits: QPPoly, babies: list[int],
                    level: int) -> dict[int, tuple[QPPoly, QPPoly]]:
        """pre[i] = σ_i(ct) in lazy QP form, its Q part carrying a factor
        P; i = 0 maps to (P·c0, P·c1) over Q with a zero P part."""
        p = self.params
        rq = p.ring_q
        P = p.p_big_int()
        c0p = rq.mul_scalar(ct.value[..., 0, :, :], P, level)
        zero_p = c0p.new_zeros(c0p.shape[:-2] + (len(p.p_moduli), p.n))
        pre: dict[int, tuple[QPPoly, QPPoly]] = {}
        for i in babies:
            if i == 0:
                c1p = rq.mul_scalar(ct.value[..., 1, :, :], P, level)
                pre[0] = (QPPoly(c0p, zero_p), QPPoly(c1p, zero_p))
                continue
            gal = p.galois_element(i)
            gk = self.ev.evk.galois_key(gal)
            acc = self.ev.gadget_product_hoisted_lazy(digits, gk.gadget, level)
            # d0 += P·c0 (Q part only), then permute both rows
            d0q = rq.add(acc.q[..., 0, :, :], c0p, level)
            idx = auto_mod.ntt_index(p.n, gal, rq.device, p.ring_type)
            pre[i] = (
                QPPoly(auto_mod.apply_ntt(d0q, idx),
                       auto_mod.apply_ntt(acc.p[..., 0, :, :], idx)),
                QPPoly(auto_mod.apply_ntt(acc.q[..., 1, :, :], idx),
                       auto_mod.apply_ntt(acc.p[..., 1, :, :], idx)),
            )
        return pre

    def evaluate(self, ct: Ciphertext, lt: LinearTransformation) -> Ciphertext:
        """lt applied to the slots of ct (a batch on leading axes); the
        output scale is ct.scale·lt.scale (mod T for BGV)."""
        with span("lintrans.evaluate"):
            return self._evaluate(ct, lt)

    def _evaluate(self, ct: Ciphertext, lt: LinearTransformation) -> Ciphertext:
        p = self.params
        rq, rp = p.ring_q, p.ring_p
        level = min(ct.level, lt.level_q)
        l = level + 1
        qq, qq_bhi, qq_inv = rq.q[:l], rq.bred_hi[:l], rq.qinv[:l]
        ct = ct.at_level(level)
        index = lt.index
        babies = sorted({i for b in index.values() for i in b})

        digits = self.ev.decompose_ntt(ct.value[..., 1, :, :], level)
        pre = self._pre_rotate(ct, digits, babies, level)
        del digits

        qmax = max(max(p.q_moduli[:l]), max(p.p_moduli))
        margin = max(2, modops.margin_for(qmax))

        def sum_q(t):      # lazy [K, ...] → [...] in [0, q)
            return modops.bred_add(modops.lazy_tree_sum(t, qq, qq_bhi, margin),
                                   qq, qq_bhi)

        def sum_p(t):
            return modops.bred_add(modops.lazy_tree_sum(t, rp.q, rp.bred_hi, margin),
                                   rp.q, rp.bred_hi)

        def mac(x, pt, ring_q: bool):
            if ring_q:
                return sum_q(modops.mred_lazy(x, _pt_aligned(pt, x), qq, qq_inv,
                                              rq.small))
            return sum_p(modops.mred_lazy(x, _pt_aligned(pt, x), rp.q, rp.qinv,
                                          rp.small))

        # baby MAC: per giant step, the stacked baby plaintexts against the
        # stacked pre-rotations, one broadcast Montgomery product and a lazy
        # tree reduction over the baby axis
        tmp_by_j: dict[int, tuple[QPPoly, QPPoly]] = {}
        for j, b_list in index.items():
            ptq = torch.stack([lt.vec[j + i].q[..., :l, :] for i in b_list])
            ptp = torch.stack([lt.vec[j + i].p for i in b_list])
            rows = []
            for r in (0, 1):
                xq = torch.stack([pre[i][r].q for i in b_list])
                xp = torch.stack([pre[i][r].p for i in b_list])
                rows.append(QPPoly(mac(xq, ptq, True), mac(xp, ptp, False)))
            tmp_by_j[j] = (rows[0], rows[1])

        # giant steps: ModDown of c1, decompose, gadget MAC against the
        # stacked Galois keys and the NTT permutation, batched over a leading
        # giant axis; then one tree reduction over all parts
        giants = [j for j in index if j != 0]
        parts0: list[QPPoly] = []
        parts1: list[QPPoly] = []
        if 0 in index:
            parts0.append(tmp_by_j[0][0])
            parts1.append(tmp_by_j[0][1])
        if giants:
            T0q = torch.stack([tmp_by_j[j][0].q for j in giants])  # [G, ..., l, N]
            T0p = torch.stack([tmp_by_j[j][0].p for j in giants])
            T1q = torch.stack([tmp_by_j[j][1].q for j in giants])
            T1p = torch.stack([tmp_by_j[j][1].p for j in giants])
            t1q = p.basis_extender.mod_down_qp_to_q(T1q, T1p, level,
                                                    ntt_domain=True)
            dg = self.ev.decompose_ntt(t1q, level)        # [G, ..., beta, l, N]
            beta = dg.q.shape[-3]
            gks = [self.ev.evk.galois_key(p.galois_element(j)) for j in giants]
            for gk in gks:
                if gk.gadget.value.q.shape[-2] < l:
                    raise ValueError(
                        f"Galois key {gk.gal_el} generated at level "
                        f"{gk.gadget.value.q.shape[-2] - 1} used at level {level}")
            evq = torch.stack([gk.gadget.value.q[:beta, :, :l, :] for gk in gks])
            evp = torch.stack([gk.gadget.value.p[:beta] for gk in gks])
            ext = (1,) * (dg.q.dim() + 1 - evq.dim())   # ct batch axes
            evq = evq.reshape(evq.shape[:1] + ext + evq.shape[1:])
            evp = evp.reshape(evp.shape[:1] + ext + evp.shape[1:])
            with span("ks.mac"):
                accq = modops.mred_sum(dg.q[..., :, None, :, :], evq, qq, qq_inv,
                                       qq_bhi, margin, rq.small)  # [G, ..., 2, l, N]
                accp = modops.mred_sum(dg.p[..., :, None, :, :], evp, rp.q, rp.qinv,
                                       rp.bred_hi, margin, rp.small)
            del dg
            d0q = rq.add(accq[..., 0, :, :], T0q, level)
            d0p = rp.add(accp[..., 0, :, :], T0p)
            d1q, d1p = accq[..., 1, :, :], accp[..., 1, :, :]
            for g, j in enumerate(giants):
                idx = auto_mod.ntt_index(p.n, p.galois_element(j), rq.device,
                                         p.ring_type)
                parts0.append(QPPoly(auto_mod.apply_ntt(d0q[g], idx),
                                     auto_mod.apply_ntt(d0p[g], idx)))
                parts1.append(QPPoly(auto_mod.apply_ntt(d1q[g], idx),
                                     auto_mod.apply_ntt(d1p[g], idx)))

        def reduce_parts(parts: list[QPPoly]):
            cq = sum_q(torch.stack([x.q for x in parts]))
            cp = sum_p(torch.stack([x.p for x in parts]))
            return p.basis_extender.mod_down_qp_to_q(cq, cp, level, ntt_domain=True)

        c0 = reduce_parts(parts0)
        c1 = reduce_parts(parts1)
        if hasattr(p, "t"):  # BGV: scales live in Z_T
            new_scale = ct.scale * lt.scale % p.t
        else:                # CKKS: exact rational scales
            new_scale = Fraction(ct.scale) * Fraction(lt.scale)
        return ct.replace(value=torch.stack([c0, c1], dim=-3), scale=new_scale)
