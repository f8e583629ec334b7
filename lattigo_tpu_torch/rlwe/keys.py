"""Key material containers + key generation.

Counterpart of :mod:`lattigo_tpu.rlwe.keys` (secret and public keys, RNS
gadget ciphertexts and their seeded, compressed form, evaluation,
relinearization and Galois keys). Key polynomials live in the
NTT + Montgomery domain over R_QP, so every key-switch MAC is one
``mred_lazy``. Randomness comes from an explicit ``torch.Generator``.

Gadget layout: at level l with |P| = alpha the l+1 limbs split into
beta = ceil((l+1)/alpha) digits; the gadget entry for digit d is P mod q_j
on rows [d·alpha, (d+1)·alpha) and 0 elsewhere. Many keys of one shape are
drawn at once on a leading batch axis (``batch``): a gadget ciphertext's
value is then ``[*batch, beta, 2, LQ, N]`` and :func:`unstack_gadgets`
splits it.

The power-of-two gadget (``base2`` = w > 0, for |P| ≤ 1, P-less key
switching included) has one row per (limb i, digit j), at i·max_digits + j,
with gadget factor P·2^{w·j} on limb i and 0 elsewhere.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from lattigo_tpu_torch.ring import modops, sampling
from lattigo_tpu_torch.ring.ring import u64_tensor
from lattigo_tpu_torch.ring import automorphism as auto_mod
from lattigo_tpu_torch.ring.ringqp import QPPoly, stack as qp_stack
from lattigo_tpu_torch.rlwe.errors import MissingGaloisKeyError
from lattigo_tpu_torch.rlwe.params import Parameters


def _mform_int(a: int, q: int) -> int:
    return (a << 64) % q


@dataclass
class SecretKey:
    """s ∈ R_QP in NTT + Montgomery form."""

    value: QPPoly


@dataclass
class PublicKey:
    """(p0, p1) = (-a·s + e, a) ∈ R_QP², NTT + Montgomery; value.q is
    int64[2, LQ, N] (leading axis: the two components)."""

    value: QPPoly


@dataclass
class GadgetCiphertext:
    """Gadget-RLWE encryption: value.q int64[beta, 2, LQ, N] (+ P part).

    Row (d, 0) = -a_d·s + e_d + m·g_d, row (d, 1) = a_d, NTT + Montgomery
    (the RGSW half made with ``row=1`` carries m·g_d on row (d, 1) instead).

    ``base2`` > 0 selects the power-of-two gadget: rows (limb i, digit j) at
    i·max_digits + j with gadget factor P·2^{base2·j} on limb i.
    """

    value: QPPoly
    base2: int = 0


def unstack_gadgets(g: GadgetCiphertext) -> list[GadgetCiphertext]:
    """Split a batch of gadget ciphertexts ([B, beta, 2, L, N]) into B."""
    p = g.value.p
    return [GadgetCiphertext(QPPoly(g.value.q[i], None if p is None else p[i]),
                             g.base2)
            for i in range(g.value.q.shape[0])]


@dataclass
class CompressedGadgetCiphertext:
    """Seeded gadget ciphertext: the c0 rows (q [beta, LQ, N], NTT +
    Montgomery) and the seed from which :meth:`expand` re-derives the
    uniform c1 rows, half the key material on the wire."""

    c0: QPPoly
    seed: bytes = b""
    base2: int = 0

    def expand(self, params: Parameters) -> GadgetCiphertext:
        level_q = self.c0.q.shape[-2] - 1
        beta = self.c0.q.shape[-3]
        c1 = _seeded_gadget_c1(params, self.seed, beta, level_q)
        rows = [qp_stack([QPPoly(self.c0.q[..., d, :, :],
                                 None if self.c0.p is None else self.c0.p[..., d, :, :]),
                          c1[d]]) for d in range(beta)]
        return GadgetCiphertext(qp_stack(rows), self.base2)


def compress_gadget(gadget: GadgetCiphertext,
                    seed: bytes) -> CompressedGadgetCiphertext:
    """Strip the seed-derived c1 rows of a gadget ciphertext made with
    ``gadget_encrypt(..., seed=seed)``."""
    p = gadget.value.p
    return CompressedGadgetCiphertext(
        c0=QPPoly(gadget.value.q[..., 0, :, :], None if p is None else p[..., 0, :, :]),
        seed=seed, base2=gadget.base2)


def keyed_uniform_qp(params: Parameters, seed: bytes, count: int,
                     level_q: int | None = None) -> list[QPPoly]:
    """``count`` uniform R_QP polynomials (NTT domain, not M-form) from one
    KeyedPRNG stream: each its Q part, then its P part."""
    prng = sampling.KeyedPRNG(seed)
    return [QPPoly(prng.uniform_poly(params.ring_q, level_q),
                   None if params.ring_p is None else prng.uniform_poly(params.ring_p))
            for _ in range(count)]


def _seeded_gadget_c1(params: Parameters, seed: bytes, beta: int,
                      level_q: int) -> list[QPPoly]:
    """The beta uniform NTT + Montgomery QP rows derived from a seed."""
    return [params.ring_qp.mform(x, level_q)
            for x in keyed_uniform_qp(params, seed, beta, level_q)]


@dataclass
class EvaluationKey:
    """Key-switching key sk_in → sk_out."""

    gadget: GadgetCiphertext


@dataclass
class RelinearizationKey:
    """Evaluation key for s² → s."""

    gadget: GadgetCiphertext


@dataclass
class GaloisKey:
    """Evaluation key enabling X^i → X^{i·gal_el}."""

    gadget: GadgetCiphertext
    gal_el: int = 0


@dataclass
class EvaluationKeySet:
    """In-memory evaluation-key set: relinearization and Galois keys."""

    relinearization_key: RelinearizationKey | None = None
    galois_keys: dict = field(default_factory=dict)   # gal_el -> GaloisKey

    def galois_key(self, gal_el: int) -> GaloisKey:
        if gal_el not in self.galois_keys:
            raise MissingGaloisKeyError(gal_el)
        return self.galois_keys[gal_el]


class KeyGenerator:
    def __init__(self, params: Parameters):
        self.params = params

    def gen_secret_key(self, gen: torch.Generator, dist=None) -> SecretKey:
        """Sample sk from params.xs, or an explicit distribution."""
        p = self.params
        x = sampling.signed(gen, p.n, p.xs if dist is None else dist)
        return self.secret_key_from_signed(x)

    def secret_key_from_signed(self, x) -> SecretKey:
        """Encode explicit signed coefficients (int64[N]) as a SecretKey."""
        rqp = self.params.ring_qp
        return SecretKey(rqp.mform(rqp.ntt(rqp.lift_signed(x))))

    def gen_public_key(self, gen: torch.Generator, sk: SecretKey) -> PublicKey:
        """(-a·s + e, a) with a uniform (NTT domain), both M-form."""
        rqp = self.params.ring_qp
        a = rqp.uniform(gen)
        e = rqp.ntt(rqp.sample_signed(gen, self.params.xe))
        p0 = rqp.sub(e, rqp.mul_mont(a, sk.value))
        return PublicKey(qp_stack([rqp.mform(p0), rqp.mform(a)]))

    def _gadget_scalars(self, level_q: int) -> torch.Tensor:
        """MForm(P mod q_j) per Q row, int64[level_q+1, 1]."""
        p = self.params
        P = p.p_big_int() if p.ring_p is not None else 1
        return u64_tensor([_mform_int(P % q, q) for q in p.q_moduli[: level_q + 1]],
                          p.device, (level_q + 1, 1))

    def _add_gadget_term(self, x: QPPoly, m_q, d: int, gfac) -> QPPoly:
        """x + m·g_d on digit d's own Q rows (M-form operands, M-form sum);
        ``gfac`` is :meth:`_gadget_scalars` at x's level."""
        rq = self.params.ring_q
        alpha = len(self.params.p_moduli)
        lo, hi = d * alpha, min((d + 1) * alpha, x.q.shape[-2])
        term = modops.mred(m_q[..., lo:hi, :], gfac[lo:hi], rq.q[lo:hi],
                           rq.qinv[lo:hi], rq.small)
        q = x.q.clone()
        q[..., lo:hi, :] = modops.add_mod(q[..., lo:hi, :], term, rq.q[lo:hi])
        return QPPoly(q, x.p)

    def _gadget_scalars_base2(self, level_q: int, w: int) -> torch.Tensor:
        """MForm(P·2^{w·j} mod q_i) for row (i, j), int64[rows, lq+1, 1];
        zero on limbs ≠ i and on digits past ceil(log2 q_i / w) (those
        digits of any value < q_i are zero anyway)."""
        p = self.params
        P = p.p_big_int() if p.ring_p is not None else 1
        lq = level_q + 1
        moduli = p.q_moduli[:lq]
        max_dig = -(-max((q - 1).bit_length() for q in moduli) // w)
        g = [[0] * lq for _ in range(lq * max_dig)]
        for i, q in enumerate(moduli):
            for j in range(-(-(q - 1).bit_length() // w)):
                g[i * max_dig + j][i] = _mform_int((P << (w * j)) % q, q)
        return u64_tensor(g, p.device, (lq * max_dig, lq, 1))

    def gadget_encrypt_base2(self, gen: torch.Generator, m_q, sk_out: SecretKey,
                             base2: int, level_q: int | None = None
                             ) -> GadgetCiphertext:
        """Power-of-two gadget encryption of m (Q part, NTT + Montgomery):
        every row drawn at once, row r = (−a_r·s + e_r + m·g_r, a_r). The
        rows past a limb's digit count are zero: they would multiply digits
        that are zero, and Lattigo's byte layout has no such rows, so a key
        read from bytes equals the key written."""
        p = self.params
        if len(p.p_moduli) > 1:
            raise ValueError("the base-2 gadget needs |P| <= 1")
        level_q = p.max_level if level_q is None else level_q
        lq = level_q + 1
        rqp, rq = p.ring_qp, p.ring_q
        gfac = self._gadget_scalars_base2(level_q, base2)     # [rows, lq, 1]
        rows = (gfac.shape[0],)
        a = rqp.uniform(gen, level_q, rows)
        c1 = rqp.mform(a, level_q)
        a_s = rqp.mul_mont(a, rqp.at_level(sk_out.value, level_q), level_q)
        e = rqp.ntt(rqp.sample_signed(gen, p.xe, level_q, rows), level_q)
        c0 = rqp.mform(rqp.sub(e, a_s, level_q), level_q)
        q = rq.q[:lq]
        term = modops.mred(m_q[..., None, :lq, :], gfac, q, rq.qinv[:lq], rq.small)
        c0 = QPPoly(modops.add_mod(c0.q, term, q), c0.p)
        value = qp_stack([c0, c1], dim=-3)
        pad = (gfac == 0).all(dim=-2)[:, 0]        # rows of no digit
        value.q[pad] = 0
        if value.p is not None:
            value.p[pad] = 0
        return GadgetCiphertext(value, base2)

    def gadget_encrypt(self, gen: torch.Generator, m_q, sk_out: SecretKey,
                       level_q: int | None = None, row: int = 0,
                       batch: tuple[int, ...] = (),
                       seed: bytes | None = None,
                       base2: int = 0) -> GadgetCiphertext:
        """Gadget-encrypt m (Q part, NTT + Montgomery, int64[..., lq+1, N]).

        ``row`` selects the component that carries m·g: 0 (evaluation keys)
        or 1 (the RGSW half with rows (−a·s + e, a + m·g)). With ``batch``
        every draw carries those leading axes; m_q and sk_out broadcast
        against them. With ``seed`` the uniform c1 rows come from the
        :class:`~lattigo_tpu_torch.ring.sampling.KeyedPRNG`, so the result
        ships compressed (:func:`compress_gadget`); it needs ``row == 0``
        and no batch. ``base2`` > 0 switches to the power-of-two gadget
        (:meth:`gadget_encrypt_base2`: ``row == 0``, no seed, no batch).
        """
        p = self.params
        if base2 > 0:
            if row != 0 or seed is not None or batch:
                raise ValueError("the base-2 gadget needs row == 0, no seed "
                                 "and no batch")
            return self.gadget_encrypt_base2(gen, m_q, sk_out, base2, level_q)
        if p.ring_p is None:
            raise NotImplementedError(
                "RNS gadget encryption requires an auxiliary P basis "
                "(use base2 > 0 for P-less key switching)")
        if row not in (0, 1):
            raise ValueError(f"row must be 0 or 1, got {row}")
        if seed is not None and (row != 0 or batch):
            raise ValueError("a seeded c1 needs row == 0 and no batch")
        level_q = p.max_level if level_q is None else level_q
        alpha = len(p.p_moduli)
        lq = level_q + 1
        beta = -(-lq // alpha)
        gfac = self._gadget_scalars(level_q)
        rqp = p.ring_qp
        sk_l = rqp.at_level(sk_out.value, level_q)
        c1_seeded = (None if seed is None
                     else _seeded_gadget_c1(p, seed, beta, level_q))
        rows = []
        for d in range(beta):
            if c1_seeded is None:
                a = rqp.uniform(gen, level_q, batch)
                c1 = rqp.mform(a, level_q)
            else:
                c1 = c1_seeded[d]           # M-form; its plain form for a·s
                a = rqp.imform(c1, level_q)
            a_s = rqp.mul_mont(a, sk_l, level_q)
            e = rqp.ntt(rqp.sample_signed(gen, p.xe, level_q, batch), level_q)
            c0 = rqp.mform(rqp.sub(e, a_s, level_q), level_q)
            if row == 0:
                c0 = self._add_gadget_term(c0, m_q, d, gfac)
            else:
                c1 = self._add_gadget_term(c1, m_q, d, gfac)
            rows.append(qp_stack([c0, c1], dim=-3))
        return GadgetCiphertext(qp_stack(rows, dim=-4))

    def gen_evaluation_key(self, gen: torch.Generator, sk_in: SecretKey,
                           sk_out: SecretKey, base2: int = 0) -> EvaluationKey:
        """Key re-encrypting from sk_in to sk_out (``base2`` > 0: the
        power-of-two gadget)."""
        return EvaluationKey(self.gadget_encrypt(gen, sk_in.value.q, sk_out,
                                                 base2=base2))

    def gen_relinearization_key(self, gen: torch.Generator, sk: SecretKey,
                                base2: int = 0) -> RelinearizationKey:
        """Gadget encryption of s² under s (``base2`` > 0: the power-of-two
        gadget)."""
        s2 = self.params.ring_q.mul_mont(sk.value.q, sk.value.q)
        return RelinearizationKey(self.gadget_encrypt(gen, s2, sk, base2=base2))

    def gen_galois_key(self, gen: torch.Generator, gal_el: int,
                       sk: SecretKey) -> GaloisKey:
        """Key for X^i → X^{i·gal_el}: s encrypted under σ_{gal_el^{-1}}(s).

        The gadget product re-encrypts from s to σ^{-1}(s); the
        automorphism applied after it lands back on s.
        """
        return self.gen_galois_keys(gen, [gal_el], sk)[gal_el]

    def gen_galois_keys(self, gen: torch.Generator, gal_els: list[int],
                        sk: SecretKey, chunk: int = 8,
                        levels: dict[int, int] | None = None
                        ) -> dict[int, GaloisKey]:
        """Galois keys in batched gadget encryptions: the permuted secrets
        of up to ``chunk`` Galois elements are stacked on a leading axis, so
        ``chunk`` bounds peak device memory (one key at logN 14 on 13 + 2
        limbs is 27.5 MB).

        ``levels`` (gal_el → level_q) makes LEVEL-SCOPED keys: a key made at
        level l has ceil((l+1)/|P|) gadget rows of l+1 Q limbs instead of
        the full chain. A key must be made at (at least) the highest level
        it is used at; the gadget product slices rows and limbs down for
        lower levels. Elements left out of ``levels`` get full-chain keys.
        """
        p = self.params
        if not gal_els:
            return {}
        if p.ring_p is None:
            raise NotImplementedError(
                "Galois keys need the RNS gadget, which needs an auxiliary "
                "P basis (P-less parameters key-switch only with base2 > 0 "
                "evaluation and relinearization keys)")
        by_level: dict[int, list[int]] = {}
        for g in gal_els:
            lvl = p.max_level if levels is None else levels.get(g, p.max_level)
            by_level.setdefault(lvl, []).append(g)
        out: dict[int, GaloisKey] = {}
        for lvl, els in sorted(by_level.items()):
            for lo in range(0, len(els), chunk):
                out.update(self._gen_galois_keys_level(
                    gen, els[lo:lo + chunk], sk, lvl))
        return out

    def _gen_galois_keys_level(self, gen: torch.Generator, gal_els: list[int],
                               sk: SecretKey, level_q: int
                               ) -> dict[int, GaloisKey]:
        p = self.params
        idx = torch.stack([auto_mod.ntt_index(p.n, p.galois_element_inverse(g),
                                              p.device, p.ring_type)
                           for g in gal_els])
        sk_out = SecretKey(QPPoly(
            torch.movedim(sk.value.q[: level_q + 1, idx], -2, 0),
            torch.movedim(sk.value.p[:, idx], -2, 0)))       # [G, L, N]
        gadgets = unstack_gadgets(self.gadget_encrypt(
            gen, sk.value.q, sk_out, level_q=level_q, batch=(len(gal_els),)))
        return {g: GaloisKey(gd, g) for g, gd in zip(gal_els, gadgets)}
