"""Homomorphic DFT: CoeffsToSlots / SlotsToCoeffs.

Counterpart of :mod:`lattigo_tpu.circuits.dft` (ref ``circuits/ckks/dft``):
the stage diagonals are the same host numpy expressions, so the encoded
matrices are the same integers. The canonical-embedding DFT
F[j,k] = ζ^{e_j·k} (e_j = 5^j mod 2N, ζ = e^{iπ/N}) factorizes into log(n)
radix-2 butterfly stages that are ROTATION-FRIENDLY in the 5-power slot
ordering (ref dft.go:377 fftPlainVec):

    F = B_{n/2}·…·B_2·B_1·Π,   B_m: tw_j = ρ_m^{5^j mod 4m}, ρ_m = e^{2πi/4m}
    row j      : out = in[j] + tw_j·in[j+m]
    row j+m    : out = in[j-m] − tw_j·in[j]        (offsets {0, ±m})

Π is the bit-reversal permutation; it is never materialized: CoeffsToSlots
applies B^{-1} stages only (slots end up holding Π·(packed coeffs)), the
point-wise EvalMod is permutation-invariant, and SlotsToCoeffs' B stages
cancel Π exactly (ref dft.go "Bit-reversed" format flag).

Consecutive stages can be merged into one BSGS linear transformation each
(ref MatrixLiteral.Levels) — depth ↔ rotation-count trade-off.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np

from lattigo_tpu_torch.circuits import lintrans as lt_mod
from lattigo_tpu_torch.rlwe.elements import Ciphertext


# ---------------------------------------------------------------------------
# Stage diagonal generation (host, numpy)
# ---------------------------------------------------------------------------

def _twiddles(n: int, m: int) -> np.ndarray:
    """Stage-B_m twiddles: the sub-transform of block size 2m uses the
    primitive 4·(2m) = 8m-th root (ζ_{2N'} for sub-ring size N' = 4m):
    tw_j = ρ^{5^j mod 8m}, ρ = e^{2πi/8m}; defined on the first half of
    each 2m-block, tiled across the n slots."""
    rho = np.exp(2j * np.pi / (8 * m))
    tw_block = np.zeros(m, dtype=np.complex128)
    e = 1
    for j in range(m):
        tw_block[j] = rho ** (e % (8 * m))
        e = e * 5 % (8 * m)
    tw = np.zeros(n, dtype=np.complex128)
    for b in range(0, n, 2 * m):
        tw[b: b + m] = tw_block
    return tw


def stage_diagonals(n: int, m: int, inverse: bool) -> dict[int, np.ndarray]:
    """Non-zero diagonals of butterfly stage B_m (or its inverse) on C^n."""
    tw = _twiddles(n, m)
    first = np.zeros(n, dtype=bool)
    for b in range(0, n, 2 * m):
        first[b: b + m] = True
    d0 = np.zeros(n, dtype=np.complex128)
    dp = np.zeros(n, dtype=np.complex128)   # offset +m
    dm = np.zeros(n, dtype=np.complex128)   # offset -m (stored at n-m)
    if not inverse:
        d0[first] = 1.0
        dp[first] = tw[first]
        second = ~first
        d0[second] = -np.roll(tw, m)[second]
        dm[second] = 1.0
    else:
        d0[first] = 0.5
        dp[first] = 0.5
        second = ~first
        inv2tw = 1.0 / (2.0 * np.roll(tw, m)[second])
        d0[second] = -1.0 / (2.0 * np.roll(tw, m)[second])
        dm[second] = inv2tw
    out = {0: d0}
    if m == n // 2:
        # +m and -m coincide mod n: merge
        out[m] = dp + dm
    else:
        out[m] = dp
        out[n - m] = dm
    return out


def compose_diagonals(n: int, d_outer: dict[int, np.ndarray],
                      d_inner: dict[int, np.ndarray]) -> dict[int, np.ndarray]:
    """Diagonals of (Outer · Inner): out[j] = Σ O_{d1}[j]·I_{d2}[(j+d1)%n]."""
    out: dict[int, np.ndarray] = {}
    for o1, v1 in d_outer.items():
        for o2, v2 in d_inner.items():
            o = (o1 + o2) % n
            term = v1 * np.roll(v2, -o1)
            if o in out:
                out[o] = out[o] + term
            else:
                out[o] = term.copy()
    return {o: v for o, v in out.items() if np.any(np.abs(v) > 1e-14)}


@functools.lru_cache(maxsize=None)
def bit_reversal_permutation(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    perm = np.zeros(n, dtype=np.int64)
    for j in range(n):
        r = 0
        x = j
        for _ in range(bits):
            r = (r << 1) | (x & 1)
            x >>= 1
        perm[j] = r
    return perm


def dft_level_diagonals(n: int, levels: list[int], inverse: bool,
                        scale_per_level: float = 1.0):
    """Group the log(n) stages into len(levels) merged matrices.

    levels[i] = number of radix-2 stages merged into matrix i, in
    APPLICATION order (first applied first). Forward (S2C): stages
    m = 1, 2, …, n/2; inverse (C2S): m = n/2, …, 2, 1.
    """
    if sum(levels) != n.bit_length() - 1:
        raise ValueError("levels must sum to log2(n)")
    ms = [1 << s for s in range(n.bit_length() - 1)]
    if inverse:
        ms = ms[::-1]
    mats = []
    idx = 0
    for nstages in levels:
        diag = None
        for _ in range(nstages):
            d = stage_diagonals(n, ms[idx], inverse)
            diag = d if diag is None else compose_diagonals(n, d, diag)
            idx += 1
        if scale_per_level != 1.0:
            diag = {o: v * scale_per_level for o, v in diag.items()}
        mats.append(diag)
    return mats


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------

class DFTEvaluator:
    """CoeffsToSlots / SlotsToCoeffs (ref dft.go:21 HomomorphicEncode/Decode)."""

    def __init__(self, params, ckks_eval, encoder,
                 c2s_levels: list[int] | None = None,
                 s2c_levels: list[int] | None = None,
                 level_q_c2s: int | None = None,
                 level_q_s2c: int | None = None,
                 c2s_scaling: float = 0.5):
        """``c2s_scaling`` is folded into the C2S matrix diagonals — into
        the FIRST matrix when ≥ 1 and the LAST when < 1 (free — ref
        dft.go:758 Scaling / bootstrapping/evaluator.go:190 C2SScaling;
        see the noise-placement comment below): 0.5 cancels the doubling
        of the conjugation split so coeffs_to_slots returns exact Re/Im
        without spending a level; the bootstrapping evaluator additionally
        folds EvalMod's 1/K interval map here, keeping the working scale
        pinned to the chain primes (scale uniformity is what preserves the
        CosDiscrete coefficient quantisation headroom)."""
        self.params = params
        self.ev = ckks_eval
        self.encoder = encoder
        n = params.max_slots
        logn = n.bit_length() - 1
        self.c2s_levels = c2s_levels or [1] * logn
        self.s2c_levels = s2c_levels or [1] * logn

        lq_c2s = params.max_level if level_q_c2s is None else level_q_c2s
        lq_s2c = params.max_level if level_q_s2c is None else level_q_s2c

        c2s_diags = dft_level_diagonals(n, self.c2s_levels, inverse=True)
        # WHERE the folded constant lives determines how much rotation
        # key-switch/rounding noise it amplifies: stage-i KS noise is
        # multiplied by every factor folded at stages ≥ i. So a factor > 1
        # (the bootstrap's 0.5·(1/K)·2^mod1_log_scale/q0, e.g. 2^12 at
        # N15QP768) goes ENTIRELY into the FIRST matrix — only stage-1
        # noise pays it, unavoidably, since its rotations precede every
        # matrix — and a factor < 1 goes entirely into the LAST, so it
        # attenuates all earlier stages' noise. (The reference distributes
        # Scaling^(1/d) per level, dft.go:163 — fold-early is never worse
        # than that for factors > 1; measured at logN=9: fold-late 13.9
        # bits, distributed and fold-early both 16.0 — stage-1 noise,
        # which pays ×factor under every policy, dominates once the later
        # stages are relieved.) The total
        # factor is unchanged, so the exact-Fraction relabel after C2S is
        # untouched; only intermediate VALUE magnitudes grow, well under
        # the chain headroom, and the matrix quantisation error RELATIVE
        # to the now-larger entries shrinks. Folding late was THE dominant
        # bootstrap error term (post-C2S slot noise 2^-27.8 rms at logN=9,
        # carried unchanged through EvalMod and S2C to the output).
        target = 0 if c2s_scaling >= 1.0 else -1
        c2s_diags[target] = {k: v * c2s_scaling
                             for k, v in c2s_diags[target].items()}
        self.c2s_mats = self._encode_mats(c2s_diags, lq_c2s)
        self.s2c_mats = self._encode_mats(
            dft_level_diagonals(n, self.s2c_levels, inverse=False), lq_s2c)
        self.lt_ev = lt_mod.LinTransEvaluator(ckks_eval)

    def _encode_mats(self, diag_list, level_q_top: int):
        p = self.params
        mats = []
        lq = level_q_top
        for diag in diag_list:
            scale = Fraction(p.q_moduli[lq])
            lt = lt_mod.encode_linear_transformation(
                p, diag, lt_mod.ckks_diag_encoder(p, self.encoder, scale),
                level_q=lq, scale=scale, slots=p.max_slots)
            mats.append(lt)
            lq -= 1
        return mats

    def with_evaluator(self, ckks_eval) -> "DFTEvaluator":
        """Swap in an evaluator (e.g. after generating the Galois keys that
        :meth:`galois_elements` reported)."""
        self.ev = ckks_eval
        self.lt_ev = lt_mod.LinTransEvaluator(ckks_eval)
        return self

    def galois_elements(self) -> list[int]:
        els = set()
        for lt in self.c2s_mats + self.s2c_mats:
            els.update(lt.galois_elements(self.params))
        els.add(self.params.galois_element_order_two)  # conjugation
        return sorted(els)

    def galois_element_levels(self) -> dict[int, int]:
        """gal_el → highest level it is used at, for LEVEL-SCOPED key
        generation (rlwe.KeyGenerator.gen_galois_keys(levels=...)): the
        hoisted rotations of each linear-transform stage run at that
        stage's level_q, so S2C keys need only the bottom few limbs —
        a multi-x key-memory saving at production parameters."""
        lvls: dict[int, int] = {}
        for lt in self.c2s_mats + self.s2c_mats:
            for el in lt.galois_elements(self.params):
                lvls[el] = max(lvls.get(el, 0), lt.level_q)
        # conjugation runs right after the last C2S rescale
        conj = self.params.galois_element_order_two
        post_c2s = self.c2s_mats[-1].level_q - 1 if self.c2s_mats else 0
        lvls[conj] = max(lvls.get(conj, 0), post_c2s)
        return lvls

    # -- pipeline ------------------------------------------------------------------

    def coeffs_to_slots(self, ct: Ciphertext):
        """ct(m) → (ct_re, ct_im): slots hold Π-ordered m_k and m_{k+n}
        (ref CoeffsToSlots dft.go:240, incl. conjugation split)."""
        ev = self.ev
        out = ct
        for lt in self.c2s_mats:
            out = ev.rescale(self.lt_ev.evaluate(out, lt))
        conj = ev.conjugate(out)
        # c2s_scaling (default 0.5) is already folded into the matrices
        # (first when ≥ 1, last when < 1 — see __init__), so the doubling
        # of the split cancels and no level is spent
        # (ref CoeffsToSlots dft.go:250-276: Conjugate/Sub/Mul(-1i)/Add).
        ct_re = ev.add(out, conj)
        ct_im = ev.mul_by_i(ev.sub(conj, out))
        return ct_re, ct_im

    def slots_to_coeffs(self, ct_re: Ciphertext,
                        ct_im: Ciphertext | None = None) -> Ciphertext:
        """(ct_re, ct_im) → ct whose poly coefficients are the slot values
        (ref SlotsToCoeffs dft.go:318). ``ct_im=None`` transforms a single
        complex-slot ciphertext directly (ref dft.go:329 ctImag==nil — the
        slim bootstrapping entry point, where the i-recombination is
        skipped because the input already packs both halves)."""
        ev = self.ev
        ct = ct_re if ct_im is None else ev.add(ct_re, ev.mul_by_i(ct_im))
        out = ct
        for lt in self.s2c_mats:
            out = ev.rescale(self.lt_ev.evaluate(out, lt))
        return out
