"""Ring packing: Expand/Pack within a ring degree, Split/Merge across them.

Counterpart of :mod:`lattigo_tpu.rlwe.ring_packing` (the reference's
``core/rlwe/ring_packing.go``, ia.cr/2020/015 alg. 2):

* expand: repeatedly split even/odd coefficients with the automorphism
  X → X^{N/n+1} (it flips the sign of odd powers), shifting odd parts down
  by X^{-2^i}; the input is first multiplied by 2^{-logN};
* pack: the inverse tree, interleaving pairs with X^{N/2^{i+1}} factors and
  the automorphisms σ_{5^{2^{i-1}}} (σ_{2N-1} at the first step);
* split: ctN[X] = ctEven[Y] + X·ctOdd[Y] with Y = X²: key-switch to the
  image of the half-degree secret, then keep every other coefficient;
* merge: the inverse, mapping both halves up in the NTT domain (a repeat
  of each value), combining, and key-switching back to the full-degree
  secret;
* extract / repack: split down to the least degree and expand there, and
  back.

Standard ring only, as in the reference.
"""

from __future__ import annotations

import torch

from lattigo_tpu_torch.ring.ringqp import QPPoly
from lattigo_tpu_torch.rlwe.elements import Ciphertext
from lattigo_tpu_torch.rlwe.evaluator import Evaluator
from lattigo_tpu_torch.rlwe.keys import EvaluationKey, KeyGenerator, SecretKey
from lattigo_tpu_torch.rlwe.params import Parameters


def map_small_to_large_ntt(x, gap: int = 2):
    """NTT-domain ring-degree raise Y = X^gap: each small value repeats gap
    times (large position j evaluates at ζ^{E(j)}, and E(j) mod 2n is
    constant over blocks of gap)."""
    return torch.repeat_interleave(x, gap, dim=-1)


def switch_large_to_small_ntt(value, params_large: Parameters,
                              params_small: Parameters, level: int):
    """NTT-domain switch X^N → Y^{N/gap}: INTT, keep every gap-th
    coefficient, NTT in the small ring."""
    gap = params_large.n // params_small.n
    coeff = params_large.ring_q.intt(value, level)
    return params_small.ring_q.ntt(coeff[..., ::gap].contiguous(), level)


def map_secret_to_large(params_large: Parameters, sk_small: SecretKey,
                        gap: int = 2) -> SecretKey:
    """A small-ring secret's image in the large ring (NTT + Montgomery
    values, as the secret is kept)."""
    q = map_small_to_large_ntt(sk_small.value.q, gap)
    p = (None if sk_small.value.p is None
         else map_small_to_large_ntt(sk_small.value.p, gap))
    return SecretKey(QPPoly(q, p))


class RingSwitchingKeys:
    """Evaluation keys between adjacent ring degrees.

    params: {log_n: Parameters} over ONE modulus chain;
    down[l]: sk_l → mapped(sk_{l-1}) in ring 2^l;
    up[l]:   mapped(sk_{l-1}) → sk_l in ring 2^l.
    """

    def __init__(self, params: dict[int, Parameters],
                 down: dict[int, EvaluationKey], up: dict[int, EvaluationKey]):
        self.params = params
        self.down = down
        self.up = up

    @property
    def min_log_n(self) -> int:
        return min(self.params)

    @property
    def max_log_n(self) -> int:
        return max(self.params)


def gen_ring_switching_keys(gen: torch.Generator, params: dict[int, Parameters],
                            sks: dict[int, SecretKey]) -> RingSwitchingKeys:
    """The adjacent-degree switching keys, drawn from ``gen`` (for each
    degree from the least up: down, then up)."""
    logs = sorted(params)
    down, up = {}, {}
    for l in logs[1:]:
        if params[l].n != 2 * params[l - 1].n:
            raise ValueError("ring degrees must be adjacent powers of two")
        if params[l].q_moduli != params[l - 1].q_moduli:
            raise ValueError("every degree must share one modulus chain")
        kgen = KeyGenerator(params[l])
        mapped = map_secret_to_large(params[l], sks[l - 1])
        down[l] = kgen.gen_evaluation_key(gen, sks[l], mapped)
        up[l] = kgen.gen_evaluation_key(gen, mapped, sks[l])
    return RingSwitchingKeys(params, down, up)


class RingPackingEvaluator:
    """Expand / Pack in ``rlwe_eval``'s ring degree (it must hold the Galois
    keys of :meth:`galois_elements_for_expand` / ``_for_pack``); with
    ``switching`` (and per-degree ``evaluators`` holding the smaller
    degrees' keys, optional) also Split / Merge / Extract / Repack across
    degrees."""

    def __init__(self, rlwe_eval: Evaluator,
                 switching: RingSwitchingKeys | None = None,
                 evaluators: dict[int, Evaluator] | None = None):
        self.ev = rlwe_eval
        self.params = rlwe_eval.params
        self.switching = switching
        self.evaluators = dict(evaluators or {})
        self.evaluators[self.params.log_n] = rlwe_eval
        if switching is not None:
            for l, p in switching.params.items():
                self.evaluators.setdefault(l, Evaluator(p))
        self._x_pow_cache: dict[tuple[int, int, int], torch.Tensor] = {}

    def _params(self, log_n: int) -> Parameters:
        if log_n == self.params.log_n:
            return self.params
        return self.switching.params[log_n]

    # -- helpers ---------------------------------------------------------------

    def _x_pow_mont(self, power: int, level: int, log_n: int) -> torch.Tensor:
        """MForm(NTT(X^power)), power taken mod 2N."""
        key = (power, level, log_n)
        hit = self._x_pow_cache.get(key)
        if hit is not None:
            return hit
        p = self._params(log_n)
        rq = p.ring_q
        k = power % (2 * p.n)
        coeffs = [0] * p.n
        coeffs[k % p.n] = 1
        poly = rq.from_int_coeffs(coeffs, level)
        if k >= p.n:
            poly = rq.neg(poly, level)
        self._x_pow_cache[key] = rq.mform(rq.ntt(poly, level), level)
        return self._x_pow_cache[key]

    def _mul_xpow(self, ct: Ciphertext, power: int, log_n: int) -> Ciphertext:
        p = self._params(log_n)
        return ct.replace(value=p.ring_q.mul_mont(
            ct.value, self._x_pow_mont(power, ct.level, log_n), ct.level))

    def galois_elements_for_expand(self, log_n: int | None = None) -> list[int]:
        p = self.params
        log_n = p.log_n if log_n is None else log_n
        return [p.n // (1 << i) + 1 for i in range(log_n)]

    def galois_elements_for_pack(self, log_start: int = 0,
                                 log_n: int | None = None) -> list[int]:
        p = self._params(self.params.log_n if log_n is None else log_n)
        els = [p.galois_element(1 << (i - 1))
               for i in range(max(1, log_start), p.log_n)]
        if log_start == 0:
            els.append(p.galois_element_order_two)
        return sorted(set(els))

    def galois_elements_for_unpack(self, log_pack: int,
                                   log_n: int | None = None) -> list[int]:
        log_n = self.params.log_n if log_n is None else log_n
        return [(1 << log_n) // (1 << i) + 1 for i in range(log_pack)]

    # -- Expand ------------------------------------------------------------------

    def expand(self, ct: Ciphertext, log_gap: int = 0) -> dict[int, Ciphertext]:
        """cts[i·2^logGap] encrypts coefficient i·2^logGap of ct in its
        constant coefficient, at the same scale."""
        if ct.degree != 1 or not ct.is_ntt:
            raise ValueError("expand takes a degree-1 NTT ciphertext")
        log_n = ct.n.bit_length() - 1
        p = self._params(log_n)
        ev = self.evaluators[log_n]
        rq = p.ring_q
        level = ct.level
        n_inv = pow(1 << log_n, -1, p.q_big_int(level))
        cts = {0: ct.replace(value=rq.mul_scalar(ct.value, n_inv, level))}
        gap = 1 << log_gap
        for i in range(log_n):
            n = 1 << i
            gal = p.n // n + 1
            for j in range(0, n, gap):
                c0 = cts[j]
                tmp = ev.automorphism(c0, gal)
                if (j + n) % gap == 0:
                    # the odd part, shifted down by X^{-2^i}
                    c1 = c0.replace(value=rq.sub(c0.value, tmp.value, level))
                    cts[j + n] = self._mul_xpow(c1, -(1 << i), log_n)
                cts[j] = c0.replace(value=rq.add(c0.value, tmp.value, level))
        return {k: v for k, v in cts.items() if k % gap == 0}

    def unpack(self, ct: Ciphertext, log_pack: int) -> list[Ciphertext]:
        """The exact inverse of ``pack(cts, input_log_gap=log_pack)``: the
        first ``log_pack`` even/odd rounds of the expand tree, so out[j]
        keeps the whole coefficient class ≡ j (mod 2^log_pack), shifted down
        by X^{-j} (a sparse ciphertext with coefficients at stride
        2^log_pack)."""
        if ct.degree != 1 or not ct.is_ntt:
            raise ValueError("unpack takes a degree-1 NTT ciphertext")
        log_n = ct.n.bit_length() - 1
        if not 0 < log_pack <= log_n:
            raise ValueError(f"log_pack {log_pack} outside (0, {log_n}]")
        p = self._params(log_n)
        ev = self.evaluators[log_n]
        rq = p.ring_q
        level = ct.level
        n_inv = pow(1 << log_pack, -1, p.q_big_int(level))
        cts = {0: ct.replace(value=rq.mul_scalar(ct.value, n_inv, level))}
        for i in range(log_pack):
            n = 1 << i
            gal = p.n // n + 1
            for j in list(cts):
                c0 = cts[j]
                tmp = ev.automorphism(c0, gal)
                odd = c0.replace(value=rq.sub(c0.value, tmp.value, level))
                cts[j + n] = self._mul_xpow(odd, -(1 << i), log_n)
                cts[j] = c0.replace(value=rq.add(c0.value, tmp.value, level))
        return [cts[j] for j in range(1 << log_pack)]

    # -- Pack --------------------------------------------------------------------

    def pack(self, cts: dict[int, Ciphertext],
             input_log_gap: int | None = None) -> Ciphertext:
        """Interleave cts[i] into one ciphertext. ``input_log_gap`` is the
        log2 spacing of the meaningful coefficients inside each input
        (default logN: only the constant coefficient; every other
        coefficient is zeroed, the extract / repack case)."""
        cts = dict(cts)
        keys = sorted(cts)
        log_n = cts[keys[0]].n.bit_length() - 1
        p = self._params(log_n)
        ev = self.evaluators[log_n]
        rq = p.ring_q
        level = cts[keys[0]].level
        input_log_gap = log_n if input_log_gap is None else input_log_gap
        log_start = log_n - input_log_gap
        n_inv = pow(1 << (log_n - log_start), -1, p.q_big_int(level))
        for k in keys:
            cts[k] = cts[k].replace(value=rq.mul_scalar(cts[k].value, n_inv, level))

        for i in range(log_start, log_n):
            t = 1 << (log_n - 1 - i)
            gal = (p.galois_element_order_two if i == 0
                   else p.galois_element(1 << (i - 1)))
            for jx in range(t):
                jy = jx + t
                a = cts.get(jx)
                b = cts.get(jy)
                if b is not None:
                    b = self._mul_xpow(b, p.n >> (i + 1), log_n)   # X^{N/2^{i+1}}
                    cts[jy] = None
                    if a is not None:
                        diff = a.replace(value=rq.sub(a.value, b.value, level))
                        asum = rq.add(a.value, b.value, level)
                        rot = ev.automorphism(diff, gal)
                        cts[jx] = a.replace(value=rq.add(asum, rot.value, level))
                    else:
                        rot = ev.automorphism(b, gal)
                        cts[jx] = b.replace(value=rq.sub(b.value, rot.value, level))
                elif a is not None:
                    rot = ev.automorphism(a, gal)
                    cts[jx] = a.replace(value=rq.add(a.value, rot.value, level))
        return cts[0]

    # -- Split / Merge (across ring degrees) --------------------------------------

    def split(self, ct: Ciphertext) -> tuple[Ciphertext, Ciphertext]:
        """ctN[X] = even[Y] + X·odd[Y], Y = X²."""
        if self.switching is None:
            raise ValueError("split needs RingSwitchingKeys")
        if ct.degree != 1 or not ct.is_ntt:
            raise ValueError("split takes a degree-1 NTT ciphertext")
        log_n = ct.n.bit_length() - 1
        if log_n <= self.switching.min_log_n:
            raise ValueError(f"cannot split below logN {self.switching.min_log_n}")
        p_large, p_small = self._params(log_n), self._params(log_n - 1)
        ev = self.evaluators[log_n]
        # skN → the image of skN/2
        tmp = ev.apply_evaluation_key(ct, self.switching.down[log_n])
        even = ct.replace(value=switch_large_to_small_ntt(
            tmp.value, p_large, p_small, ct.level))
        odd_large = self._mul_xpow(tmp, -1, log_n)
        odd = ct.replace(value=switch_large_to_small_ntt(
            odd_large.value, p_large, p_small, ct.level))
        return even, odd

    def merge(self, ct_even: Ciphertext | None,
              ct_odd: Ciphertext | None) -> Ciphertext:
        """even[Y] + X·odd[Y] → ctN[X]."""
        if self.switching is None:
            raise ValueError("merge needs RingSwitchingKeys")
        some = ct_even if ct_even is not None else ct_odd
        log_n = some.n.bit_length()          # the small logN + 1
        p_large = self._params(log_n)
        level = some.level
        v = None
        if ct_even is not None:
            v = map_small_to_large_ntt(ct_even.value)
        if ct_odd is not None:
            up = some.replace(value=map_small_to_large_ntt(ct_odd.value))
            up = self._mul_xpow(up, 1, log_n)
            v = up.value if v is None else p_large.ring_q.add(v, up.value, level)
        # the image of skN/2 → skN
        return self.evaluators[log_n].apply_evaluation_key(
            some.replace(value=v), self.switching.up[log_n])

    # -- Extract / Repack ---------------------------------------------------------

    def extract(self, ct: Ciphertext, idx: list[int]) -> dict[int, Ciphertext]:
        """cts[i] (ring degree min_log_n) encrypts coefficient i of ct in its
        constant coefficient, for i in idx; other coefficients are zeroed."""
        log_max = ct.n.bit_length() - 1
        log_min = self.switching.min_log_n if self.switching else log_max
        shift = log_max - log_min
        n_factor = 1 << shift

        # halve the ring degree recursively: original coefficient k lands in
        # small ciphertext k mod n_factor at position k // n_factor
        tmp = {0: ct}
        for i in range(shift):
            t = 1 << i
            needed = {k & (2 * t - 1) for k in idx}
            for j in list(tmp):
                if j in needed or (j + t) in needed:
                    tmp[j], tmp[j + t] = self.split(tmp[j])

        out = {}
        by_res: dict[int, list[int]] = {}
        for k in idx:
            by_res.setdefault(k & (n_factor - 1), []).append(k)
        for res, ks in by_res.items():
            gaps = {k >> shift for k in ks} - {0}
            log_gap = (min((g & -g).bit_length() - 1 for g in gaps) if gaps
                       else log_min)
            small = self.expand(tmp[res], min(log_gap, log_min))
            for k in ks:
                out[k] = small[k >> shift]
        return out

    def repack(self, cts: dict[int, Ciphertext]) -> Ciphertext:
        """The inverse of :meth:`extract`: the constant coefficients of the
        small ciphertexts packed into coefficient i of one ciphertext of the
        greatest degree."""
        keys = sorted(cts)
        log_min = cts[keys[0]].n.bit_length() - 1
        log_max = (self.params.log_n if self.switching is None
                   else self.switching.max_log_n)
        shift = log_max - log_min
        n_factor = 1 << shift

        # bucket by residue, pack each bucket, then a base-2 merge tree
        buckets: list[dict[int, Ciphertext]] = [{} for _ in range(n_factor)]
        for k in keys:
            buckets[k & (n_factor - 1)][k >> shift] = cts[k]
        merged = {i: (self.pack(b) if b else None) for i, b in enumerate(buckets)}
        for i in range(shift - 1, -1, -1):
            t = 1 << i
            for j in range(t):
                if merged.get(j) is not None or merged.get(j + t) is not None:
                    merged[j] = self.merge(merged.get(j), merged.get(j + t))
                    merged[j + t] = None
        return merged[0]
