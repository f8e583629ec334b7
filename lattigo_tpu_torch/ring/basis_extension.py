"""RNS basis extension: ModUp / ModDown / gadget decomposition.

Counterpart of :mod:`lattigo_tpu.ring.basis_extension`. The fast basis
conversion is a contraction over source limbs:

    y_i   = x_i · (Q/q_i)^{-1}            (mod q_i)
    v     = round(Σ_i y_i / q_i)          (overflow count)
    out_j = Σ_i y_i · (Q/q_i) − v·Q       (mod p_j)

v is computed in exact 128-bit fixed point (two 64-bit words of
⌊2^128/q_i⌋ per limb). On int64 tensors the carries of that 128-bit sum
use unsigned compares (:func:`modops.ult`) and the rounding bit is read
with a logical shift. The limb contraction accumulates lazily with
flushes every ``margin`` terms, derived from 2^63.

The contraction runs as one exact int8 digit matmul when every modulus is
< 2^29 and 6 ≤ Li ≤ 256 (:func:`_mod_up_contract_mxu`, the JAX package's
rule, which it applies on a TPU only; here on every device), as a raw
multiply-accumulate when every modulus is < 2^30, and as a Montgomery MAC
otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from lattigo_tpu_torch.ring import modops
from lattigo_tpu_torch.ring.ntt_u64_mxu import _balanced_digits, _digits8
from lattigo_tpu_torch.ring.ring import u64_tensor
from lattigo_tpu_torch.trace import span

_U64 = np.uint64


def _mform_int(a: int, q: int) -> int:
    return (a << 64) % q


def _small(moduli) -> bool:
    return max(moduli) < (1 << modops.SMALL_Q_BITS)


class ModUpConstants:
    """Precomputed tables for basis conversion src_moduli → dst_moduli."""

    def __init__(self, src_moduli: list[int], dst_moduli: list[int], device):
        self.src_moduli = list(src_moduli)
        self.dst_moduli = list(dst_moduli)
        Q = 1
        for q in src_moduli:
            Q *= q
        Li, Lj = len(src_moduli), len(dst_moduli)
        dev = torch.device(device)

        self.qhatinv = u64_tensor(
            [_mform_int(pow((Q // q) % q, -1, q), q) for q in src_moduli],
            dev, (Li, 1))                                        # M-form
        qhat_dst = np.zeros((Li, Lj), dtype=_U64)
        for i, q in enumerate(src_moduli):
            for j, p in enumerate(dst_moduli):
                qhat_dst[i, j] = _mform_int((Q // q) % p, p)
        self.qhat_dst = u64_tensor(qhat_dst, dev)               # M-form
        self.qneg_dst = u64_tensor(
            [_mform_int((-Q) % p, p) for p in dst_moduli], dev, (Lj, 1))

        w = [(1 << 128) // q for q in src_moduli]
        self.whi = u64_tensor([(x >> 64) & 0xFFFFFFFFFFFFFFFF for x in w], dev, (Li, 1))
        self.wlo = u64_tensor([x & 0xFFFFFFFFFFFFFFFF for x in w], dev, (Li, 1))

        self.margin = modops.margin_for(max(dst_moduli))
        self.src_q = u64_tensor(src_moduli, dev, (Li, 1))
        self.src_qinv = u64_tensor(
            [modops.gen_mred_constant(q) for q in src_moduli], dev, (Li, 1))
        self.src_small = _small(src_moduli)
        self.dst_small = _small(dst_moduli)

        # Cross-size hazard: when every dst prime is below the 32-bit
        # cascade's bound but a src prime is not, mred_lazy(y_i, ·) would
        # take the cascade with a 30+-bit operand y_i, breaking its a < 4q
        # contract (exact corruption for src primes ≥ 2^52 with T=2^16+1,
        # the BGV decode Q→T conversion). mod_up pre-reduces y mod the dst
        # primes in that case.
        self.prereduce_src = self.dst_small and not self.src_small

        # All moduli < 2^30: y_i·(qhat mod p_j) < 2^60 is summed raw.
        self.small = self.src_small and self.dst_small
        if self.small:
            qhat_plain = np.zeros((Li, Lj), dtype=_U64)
            for i, q in enumerate(src_moduli):
                for j, p in enumerate(dst_moduli):
                    qhat_plain[i, j] = (Q // q) % p
            self.qhat_plain = u64_tensor(qhat_plain, dev)
            self.qneg_plain = u64_tensor([(-Q) % p for p in dst_moduli], dev)
            # terms < 2^60: flush cadence of the raw int64 sum
            self.margin_small = max(1, ((1 << 63) - 1) // (1 << 60) - 1)

        # Digit-matmul path (all moduli < 2^29, 6 ≤ Li ≤ 256): the limb
        # contraction Σ_i y_i·(qhat_i mod p_j) as one exact int8 matmul.
        # W[(d, i), (s, j)] = digit_s((2^{8d}·qhat_i) mod p_j); the four
        # int32 planes recombine in int64 (|Σ_s P_s·2^{8s}| < Li·2^41) with
        # one Barrett per output element. Li and Lj are padded to even
        # counts with zero rows and columns, so that the matmul's K = 4·Li
        # and N = 4·Lj are multiples of 8.
        self.mxu = max(src_moduli + dst_moduli) < (1 << 29) and 6 <= Li <= 256
        if self.mxu:
            self.li_pad, self.lj_pad = Li + Li % 2, Lj + Lj % 2
            ext = np.zeros((4, self.li_pad, self.lj_pad), dtype=_U64)
            for i, q in enumerate(src_moduli):
                qh = Q // q
                for j, p in enumerate(dst_moduli):
                    for d in range(4):
                        ext[d, i, j] = ((1 << (8 * d)) * qh) % p
            w = _balanced_digits(ext, 4).transpose(0, 1, 3, 2)   # [d, i, s, j]
            self.w_mxu = torch.from_numpy(np.ascontiguousarray(w).reshape(
                4 * self.li_pad, 4 * self.lj_pad)).to(dev)
            # per output limb, a multiple of p_j ≥ 2^51 that makes the
            # signed recombination non-negative before the Barrett
            self.cshift = u64_tensor([((1 << 51) // p) * p for p in dst_moduli], dev)
            self.plane_shifts = torch.tensor([[1], [1 << 8], [1 << 16], [1 << 24]],
                                             dtype=torch.int64, device=dev)


def overflow_count(y, whi, wlo, centered: bool):
    """v = floor/round(Σ_i y_i/q_i) via exact 128-bit fixed point.

    y: int64[..., Li, N] with y_i < q_i; whi/wlo: [..., Li, 1]. Returns
    int64[..., N].
    """
    t_hi = y * whi + modops.mul_hi(y, wlo)
    t_lo = y * wlo
    shape = t_lo.shape[:-2] + t_lo.shape[-1:]
    acc_lo = torch.zeros(shape, dtype=torch.int64, device=y.device)
    acc_hi = torch.zeros_like(acc_lo)
    v = torch.zeros_like(acc_lo)
    for i in range(t_lo.shape[-2]):
        lo = t_lo[..., i, :]
        hi = t_hi[..., i, :]
        new_lo = acc_lo + lo
        new_hi = acc_hi + hi + modops.ult(new_lo, lo).to(torch.int64)
        v = v + modops.ult(new_hi, hi).to(torch.int64)   # carry out of 128 bits
        acc_lo, acc_hi = new_lo, new_hi
    if centered:
        v = v + modops.srl(acc_hi, 63)
    return v


def _mod_up_contract_mxu(y, v, consts: ModUpConstants, dst_q, dst_bhi):
    """The limb contraction as one exact int8 digit matmul.

    y: int64[..., Li, N] canonical; v: int64[..., N] overflow count.
    Returns int64[..., Lj, N] in [0, p_j).
    """
    Li, Lj = len(consts.src_moduli), len(consts.dst_moduli)
    lead, n = y.shape[:-2], y.shape[-1]
    y3 = y.reshape(-1, Li, n)
    if consts.li_pad != Li:
        y3 = torch.cat([y3, y3.new_zeros(y3.shape[0], consts.li_pad - Li, n)], dim=1)
    dig = _digits8(y3, (0, 2, 3, 1), 4).view(-1, 4 * consts.li_pad)  # [(b, N), (d, i)]
    p32 = torch._int_mm(dig, consts.w_mxu)                           # [(b, N), (s, j)]
    t = (p32.view(-1, n, 4, consts.lj_pad).to(torch.int64)
         * consts.plane_shifts).sum(dim=-2)[..., :Lj]                # |t| < 2^51
    tu = torch.movedim(t + consts.cshift, -1, -2)                    # [b, Lj, N]
    acc = tu + v.reshape(-1, 1, n) * consts.qneg_plain[:, None]
    return modops.bred_add(acc, dst_q, dst_bhi).reshape(lead + (Lj, n))


def mod_up(x, consts: ModUpConstants, dst_q, dst_qinv, dst_bhi,
           centered: bool = True):
    """Basis-convert x (int64[..., Li, N], coeff domain) to [..., Lj, N]."""
    y = modops.mred(x, consts.qhatinv, consts.src_q, consts.src_qinv,
                    consts.src_small)
    return mod_up_contract(y, consts, dst_q, dst_qinv, dst_bhi, centered)


def mod_up_contract(y, consts: ModUpConstants, dst_q, dst_qinv, dst_bhi,
                    centered: bool = True):
    """The limb contraction of :func:`mod_up`, from y_i = x_i·(Q/q_i)^{-1}
    (int64[..., Li, N], canonical): a rank that holds some source limbs
    computes their y_i and gathers the rest (``parallel.spmd``)."""
    v = overflow_count(y, consts.whi, consts.wlo, centered)
    if consts.mxu:
        return _mod_up_contract_mxu(y, v, consts, dst_q, dst_bhi)
    if consts.small:
        # raw MAC (terms < 2^60) + one Barrett per output element
        t = y[..., :, None, :] * consts.qhat_plain[:, :, None]
        acc = modops.lazy_tree_sum(torch.movedim(t, -3, 0), dst_q, dst_bhi,
                                   consts.margin_small)
        acc = acc + v[..., None, :] * consts.qneg_plain[:, None]
        return modops.bred_add(acc, dst_q, dst_bhi)
    yb = y[..., :, None, :]
    if consts.prereduce_src:
        yb = modops.bred_add(yb, dst_q, dst_bhi)
    t = modops.mred_lazy(yb, consts.qhat_dst[:, :, None], dst_q, dst_qinv,
                         consts.dst_small)
    acc = modops.lazy_tree_sum(torch.movedim(t, -3, 0), dst_q, dst_bhi,
                               consts.margin)
    acc = acc + modops.mred_lazy(v[..., None, :], consts.qneg_dst, dst_q,
                                 dst_qinv, consts.dst_small)
    return modops.bred_add(acc, dst_q, dst_bhi)


class BasisExtender:
    """Q↔P conversion + exact division by P; methods take ``level_q`` and
    use the full P chain."""

    def __init__(self, ring_q, ring_p):
        self.ring_q = ring_q
        self.ring_p = ring_p
        dev = ring_q.device
        lq = len(ring_q.moduli)
        self._q_to_p = [ModUpConstants(ring_q.moduli[: l + 1], ring_p.moduli, dev)
                        for l in range(lq)]
        self._p_to_q = [ModUpConstants(ring_p.moduli, ring_q.moduli[: l + 1], dev)
                        for l in range(lq)]
        P = 1
        for p in ring_p.moduli:
            P *= p
        self.pinv_q = u64_tensor(
            [_mform_int(pow(P % q, -1, q), q) for q in ring_q.moduli], dev, (lq, 1))
        self.p_modulus = P

    def mod_up_q_to_p(self, x, level_q: int, centered: bool = True):
        rp = self.ring_p
        return mod_up(x, self._q_to_p[level_q], rp.q, rp.qinv, rp.bred_hi, centered)

    def mod_up_p_to_q(self, x, level_q: int, centered: bool = True):
        rq = self.ring_q
        l = level_q + 1
        return mod_up(x, self._p_to_q[level_q], rq.q[:l], rq.qinv[:l],
                      rq.bred_hi[:l], centered)

    def mod_down_qp_to_q(self, xq, xp, level_q: int, ntt_domain: bool = False):
        """(x mod QP) → round(x/P) mod Q; both parts NTT-domain if
        ``ntt_domain``, else coefficient domain."""
        rq = self.ring_q
        l = level_q + 1
        with span("ks.moddown"):
            if ntt_domain:
                xp = self.ring_p.intt(xp)
            lift = self.mod_up_p_to_q(xp, level_q, centered=True)
            if ntt_domain:
                lift = rq.ntt(lift, level=level_q)
            diff = modops.sub_mod(xq, lift, rq.q[:l])
            return modops.mred(diff, self.pinv_q[:l], rq.q[:l], rq.qinv[:l], rq.small)


class Decomposer:
    """RNS gadget decomposition for key switching: the Q limbs at level l
    split into ``beta = ceil((l+1)/alpha)`` digits of ``alpha = |P|`` limbs;
    digit d is base-converted to the full QP basis (its own limbs pass
    through unchanged)."""

    def __init__(self, ring_q, ring_p):
        self.ring_q = ring_q
        self.ring_p = ring_p
        self.alpha = len(ring_p.moduli)
        self._consts: dict = {}

    def num_digits(self, level_q: int) -> int:
        return -(-(level_q + 1) // self.alpha)

    def digit_range(self, level_q: int, d: int) -> tuple[int, int]:
        lo = d * self.alpha
        return lo, min((d + 1) * self.alpha, level_q + 1)

    def _dst(self, level_q: int):
        """(q, qinv, bred_hi, small) of the QP basis at level_q."""
        key = ("dst", level_q)
        if key not in self._consts:
            rq, rp = self.ring_q, self.ring_p
            lq = level_q + 1
            self._consts[key] = (
                torch.cat([rq.q[:lq], rp.q]), torch.cat([rq.qinv[:lq], rp.qinv]),
                torch.cat([rq.bred_hi[:lq], rp.bred_hi]),
                _small(rq.moduli[:lq] + rp.moduli))
        return self._consts[key]

    def _get_consts(self, level_q: int, d: int) -> ModUpConstants:
        key = (level_q, d)
        if key not in self._consts:
            lo, hi = self.digit_range(level_q, d)
            self._consts[key] = ModUpConstants(
                self.ring_q.moduli[lo:hi],
                self.ring_q.moduli[: level_q + 1] + self.ring_p.moduli,
                self.ring_q.device)
        return self._consts[key]

    def _stacked_consts(self, level_q: int):
        """Digit-stacked ModUp tables for :meth:`decompose_all`; rows of the
        padded last digit carry zero tables."""
        key = ("stacked", level_q)
        if key in self._consts:
            return self._consts[key]
        rq, rp = self.ring_q, self.ring_p
        lq = level_q + 1
        a = self.alpha
        beta = self.num_digits(level_q)
        Lj = lq + len(rp.moduli)
        dev = rq.device
        i64 = dict(dtype=torch.int64, device=dev)
        qhatinv = torch.zeros((beta, a, 1), **i64)
        whi = torch.zeros((beta, a, 1), **i64)
        wlo = torch.zeros((beta, a, 1), **i64)
        src_q = torch.ones((beta, a, 1), **i64)
        src_qinv = torch.ones((beta, a, 1), **i64)
        qhat_dst = torch.zeros((beta, a, Lj), **i64)
        qneg_dst = torch.zeros((beta, Lj, 1), **i64)
        pass_mask = torch.zeros((beta, Lj, 1), dtype=torch.bool, device=dev)
        margin = 1 << 62
        src_max = 1
        for d in range(beta):
            c = self._get_consts(level_q, d)
            k = len(c.src_moduli)
            qhatinv[d, :k] = c.qhatinv
            whi[d, :k] = c.whi
            wlo[d, :k] = c.wlo
            src_q[d, :k] = c.src_q
            src_qinv[d, :k] = c.src_qinv
            qhat_dst[d, :k] = c.qhat_dst
            qneg_dst[d] = c.qneg_dst
            margin = min(margin, c.margin)
            src_max = max(src_max, *c.src_moduli)
            lo, hi = self.digit_range(level_q, d)
            pass_mask[d, lo:hi] = True
        out = dict(qhatinv=qhatinv, whi=whi, wlo=wlo, src_q=src_q,
                   src_qinv=src_qinv, qhat_dst=qhat_dst, qneg_dst=qneg_dst,
                   margin=margin, pass_mask=pass_mask, beta=beta,
                   src_small=_small([src_max]))
        self._consts[key] = out
        return out

    def decompose_all(self, x_coeff, level_q: int):
        """All digits at once: (yq [..., beta, l+1, N], yp [..., beta, LP, N]).

        Small chains run the per-digit raw-MAC or digit-matmul path; others
        one broadcast Montgomery program over a digit axis.
        """
        lq = level_q + 1
        c0 = self._get_consts(level_q, 0)
        if c0.small or c0.mxu:
            ys = [self.decompose_single(x_coeff, level_q, d)
                  for d in range(self.num_digits(level_q))]
            return (torch.stack([y[0] for y in ys], dim=-3),
                    torch.stack([y[1] for y in ys], dim=-3))
        c = self._stacked_consts(level_q)
        beta, a = c["beta"], self.alpha
        dst_q, dst_qinv, dst_bhi, dst_small = self._dst(level_q)
        Lj = dst_q.shape[0]
        pad = beta * a - lq
        x = x_coeff
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[:-2] + (pad, x.shape[-1]))], dim=-2)
        xg = x.reshape(x.shape[:-2] + (beta, a, x.shape[-1]))
        y = modops.mred(xg, c["qhatinv"], c["src_q"], c["src_qinv"], c["src_small"])
        v = overflow_count(y, c["whi"], c["wlo"], centered=True)
        tq = modops.mred_lazy(y[..., :, None, :], c["qhat_dst"][..., :, :, None],
                              dst_q, dst_qinv, dst_small)
        acc = modops.lazy_tree_sum(torch.movedim(tq, -3, 0), dst_q, dst_bhi,
                                   c["margin"])
        acc = acc + modops.mred_lazy(v[..., None, :], c["qneg_dst"], dst_q,
                                     dst_qinv, dst_small)
        extd = modops.bred_add(acc, dst_q, dst_bhi)         # [..., beta, Lj, N]
        xb = torch.cat([x_coeff, x_coeff.new_zeros(
            x_coeff.shape[:-2] + (Lj - lq, x_coeff.shape[-1]))], dim=-2)
        extd = torch.where(c["pass_mask"], xb[..., None, :, :], extd)
        return extd[..., :lq, :], extd[..., lq:, :]

    def decompose_single(self, x_coeff, level_q: int, d: int):
        """Digit d of x (coeff domain [..., l+1, N]) extended to basis QP:
        (yq [..., l+1, N], yp [..., LP, N]); the digit's own limbs pass
        through exactly."""
        lo, hi = self.digit_range(level_q, d)
        lq = level_q + 1
        dst_q, dst_qinv, dst_bhi, _ = self._dst(level_q)
        ext = mod_up(x_coeff[..., lo:hi, :], self._get_consts(level_q, d),
                     dst_q, dst_qinv, dst_bhi, True)
        ext[..., lo:hi, :] = x_coeff[..., lo:hi, :]
        return ext[..., :lq, :], ext[..., lq:, :]
