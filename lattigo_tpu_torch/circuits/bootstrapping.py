"""CKKS bootstrapping: ScaleDown → ModUp → CoeffsToSlots → EvalMod → SlotsToCoeffs.

Counterpart of :mod:`lattigo_tpu.circuits.bootstrapping` (pipeline ref
``circuits/ckks/bootstrapping`` evaluator.go:518): full-slot bootstrapping
on the standard ring with exact Fraction scale bookkeeping, sparse-secret
encapsulation, both circuit orders and META-BTS iterations. The level
layout, every constant folded into the DFT matrices and every scale
relabel are the JAX package's, value for value, so the two give the same
residues on the same keys and input.

Scale plumbing (host metadata beside the residue tensors):

* ScaleDown brings the ciphertext to level 0; its scale Δ₀ defines the
  message ratio q₀/Δ₀ ≳ 2^{log_message_ratio}.
* ModUp lifts [c0,c1] centered from q₀ to the full chain; relabeling the
  scale to q₀ makes slot values y = m/q₀ + I after CoeffsToSlots.
* EvalMod returns slots ≈ m/q₀; the final relabel scale ← Δ·Δ₀/q₀ restores
  the true message — metadata only, no device work.

The sparse ``bootstrap_many`` packs with the ring-packing evaluator
(:mod:`lattigo_tpu_torch.rlwe.ring_packing`), and
``evaluate_conjugate_invariant`` bridges through the CKKS domain switcher
(:mod:`lattigo_tpu_torch.schemes.ckks.bridge`).

Not ported here:

* the JAX package's ``jitted`` has no counterpart, by design: it splits the
  pipeline into separately compiled XLA programs and streams host-resident
  DFT matrices and keys into a small device memory. The port runs the
  stages eagerly, and one card holds the whole working set (encoded
  matrices and level-scoped Galois keys) at the published presets. A
  CUDA-graph capture of the pipeline is a performance item of its own
  (ROADMAP.md queue 2);
* the ``bootstrap_fn`` argument of the JAX package's ``bootstrap_many``
  (it substitutes ``jitted``'s pipeline); a caller that needs another
  refresh swaps the instance's ``bootstrap``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction

import numpy as np
import torch

from lattigo_tpu_torch.circuits import dft as dft_mod
from lattigo_tpu_torch.circuits.mod1 import (
    COS_DISCRETE, SIN_CONTINUOUS, Mod1Evaluator, Mod1Parameters,
)
from lattigo_tpu_torch.ring import modops
from lattigo_tpu_torch.rlwe.elements import Ciphertext
from lattigo_tpu_torch.trace import span


# Circuit orders (ref bootstrapping/parameters_literal.go:144 CircuitOrder):
# the standard pipeline, and the "slim" reordering of Chen-Han
# (ia.cr/2018/067) where homomorphic decoding runs first so a circuit can
# execute in the coefficient domain between S2C and ModUp.
MODUP_THEN_ENCODE = "modup-then-encode"   # ScaleDown→ModUp→C2S→EvalMod→S2C
DECODE_THEN_MODUP = "decode-then-modup"   # S2C→ScaleDown→ModUp→C2S→EvalMod

@dataclass
class BootstrappingParameters:
    """ref bootstrapping/parameters_literal.go:15 (subset)."""

    c2s_levels: list[int] = field(default_factory=lambda: [1, 1, 1, 1])
    s2c_levels: list[int] = field(default_factory=lambda: [1, 1, 1])
    mod1: Mod1Parameters = field(default_factory=Mod1Parameters)
    residual_levels: int = 1   # levels available to the user after bootstrap
    # Sparse-secret encapsulation (ia.cr/2022/024, ref EphemeralSecretWeight):
    # ModUp runs under an ephemeral sparse key of this Hamming weight, which
    # shrinks the EvalMod integer bound K. None disables encapsulation.
    ephemeral_secret_weight: int | None = None
    # ref parameters_literal.go:147-148 — see MODUP_THEN_ENCODE above.
    circuit_order: str = MODUP_THEN_ENCODE


@dataclass
class BootstrappingKeys:
    """Encapsulation key pair (ref bootstrapping/keys.go:15)."""

    evk_dense_to_sparse: object = None   # rlwe.EvaluationKey
    evk_sparse_to_dense: object = None


class BootstrappingEvaluator:
    """ref bootstrapping/evaluator.go:22."""

    def __init__(self, params, ckks_eval, encoder, bts_params: BootstrappingParameters):
        self.params = params
        self.ev = ckks_eval
        self.encoder = encoder
        self.btp = bts_params
        # Plaintext-side tracing hook (ref bootstrapping/evaluator.go:22-48
        # SkDebug): set to the secret key to print per-stage decryptions.
        # See :meth:`with_sk_debug`.
        self.sk_debug = None

        L = params.max_level
        # C2S consumes exactly one matrix level per entry: the 0.5
        # conjugation split is a free scale-metadata change (see
        # DFTEvaluator.coeffs_to_slots), matching the reference budget.
        n_c2s = len(bts_params.c2s_levels)
        n_s2c = len(bts_params.s2c_levels)
        mod1_depth = self._mod1_depth(bts_params.mod1)
        self.level_c2s_top = L
        self.level_mod1_top = L - n_c2s
        if bts_params.circuit_order == MODUP_THEN_ENCODE:
            # level layout (top to bottom): C2S | EvalMod | S2C | residual | q0
            self.level_s2c_top = self.level_mod1_top - mod1_depth
            short = self.level_s2c_top - n_s2c < bts_params.residual_levels
        elif bts_params.circuit_order == DECODE_THEN_MODUP:
            # slim layout (top to bottom): C2S | EvalMod | slots circuit | S2C | q0
            # S2C sits directly above q0 so the decoded ciphertext lands at
            # level 0 ready for ModUp (ref slim example chain ordering).
            self.level_s2c_top = n_s2c
            short = (self.level_mod1_top - mod1_depth - n_s2c
                     < bts_params.residual_levels)
        else:
            raise ValueError(
                f"invalid circuit_order {bts_params.circuit_order!r}")
        if short:
            raise ValueError(
                f"modulus chain too short: need ≥ "
                f"{n_c2s + mod1_depth + n_s2c + bts_params.residual_levels + 1} levels")

        # fold ALL free constants into the C2S matrices: the 0.5 of the
        # conjugation split, EvalMod's interval map 1/K (the Chebyshev
        # variable is u = y/K for every mod1 type — see mod1._gen_poly),
        # and — when the mod1 working scale is pinned — the anticipation
        # factor 2^log_scale/q0 that the post-C2S relabel divides back out
        # (ref bootstrapping/evaluator.go:190 C2SScaling = qDiv/(K·qDiff)).
        m1 = bts_params.mod1
        in_const = 1.0 / m1.k
        # Pinning the working scale keeps the Chebyshev power basis at the
        # (≈ equal) EvalMod chain primes instead of drifting by Δ_in/q_em
        # per doubling — drifting scales amplify RLWE noise into message
        # error.
        self._mod1_scale = (None if m1.log_scale is None
                            else Fraction(2) ** m1.log_scale)
        # ModUp amplification (ref evaluator.go:709 "Scale the message from
        # Q0/|m| to QL/|m|"): the lifted payload m + q0·I is TINY against
        # the full chain, so it is multiplied by round(2^log_scale/q0) ≈
        # 2^17 at N15QP768 as an EXACT integer scalar right after the lift
        # — before the sparse→dense switch and before every C2S rotation.
        # Every downstream key-switch/ModDown/rescale rounding error then
        # lands on a 2^17×-larger payload, i.e. is suppressed by the same
        # factor relative to the message.
        if self._mod1_scale is None:
            self._modup_scalar = 1
            anticipate = 1.0
        else:
            q0_f = Fraction(params.q_moduli[0])
            self._modup_scalar = max(1, round(float(self._mod1_scale / q0_f)))
            # residual (non-integer) part of the division by q0, folded
            # into the C2S constants; ≈ 1 once the scalar took the bulk
            anticipate = float(self._mod1_scale / (q0_f * self._modup_scalar))
        self.dft = dft_mod.DFTEvaluator(
            params, ckks_eval, encoder,
            c2s_levels=bts_params.c2s_levels,
            s2c_levels=bts_params.s2c_levels,
            level_q_c2s=self.level_c2s_top,
            level_q_s2c=self.level_s2c_top,
            c2s_scaling=0.5 * in_const * anticipate)
        self.mod1 = Mod1Evaluator(ckks_eval, bts_params.mod1)

    def with_sk_debug(self, sk) -> "BootstrappingEvaluator":
        """Enable plaintext-side stage tracing (ref SkDebug,
        bootstrapping/evaluator.go:22-48): every pipeline stage of
        :meth:`bootstrap` decrypts its output and prints level / scale /
        magnitude (a host sync per stage: a debugging aid only)."""
        self.sk_debug = sk
        return self

    def _debug(self, tag: str, ct: Ciphertext) -> None:
        if self.sk_debug is None:
            return
        from lattigo_tpu_torch.rlwe.encryption import Decryptor
        got = self.encoder.decode(
            Decryptor(self.params, self.sk_debug).decrypt(ct))
        mag = float(np.abs(got).max())
        print(f"[sk_debug] {tag}: level={ct.level} "
              f"scale=2^{float(np.log2(float(ct.scale))):.2f} "
              f"|slots|max={mag:.4g}")

    @staticmethod
    def _mod1_depth(m1: Mod1Parameters) -> int:
        # Paterson-Stockmeyer (exactly bit_length(degree) levels) +
        # double-angle squarings (r) + optional arcsine — matching the
        # reference budget exactly (ref mod1_parameters.go:57 Depth():
        # the interval map is a free scale-metadata change and P-S is
        # depth-exact).
        degree = m1.degree
        if m1.mod1_type == COS_DISCRETE:
            degree = max(degree, 2 * m1.k - 1)  # ref parameters_literal Depth()
        r = 0 if m1.mod1_type == SIN_CONTINUOUS else m1.double_angle
        poly_depth = max(1, degree.bit_length())
        arcsine = (max(1, m1.arcsine_degree.bit_length())
                   if m1.arcsine_degree > 0 else 0)
        return poly_depth + r + arcsine

    def with_evaluator(self, ckks_eval) -> "BootstrappingEvaluator":
        """Swap in an evaluator (e.g. one holding the Galois keys that
        :meth:`galois_elements` reported)."""
        self.ev = ckks_eval
        self.dft.with_evaluator(ckks_eval)
        self.mod1.ev = ckks_eval
        self.mod1.poly_eval.ev = ckks_eval
        return self

    def gen_encapsulation_keys(self, gen: torch.Generator, sk) -> BootstrappingKeys:
        """Ephemeral sparse key + the dense↔sparse switching EVKs, drawn
        from ``gen`` (ref bootstrapping/keys.go:69 GenEvaluationKeys)."""
        if self.btp.ephemeral_secret_weight is None:
            return BootstrappingKeys()
        from lattigo_tpu_torch.ring.sampling import Ternary
        from lattigo_tpu_torch.rlwe.keys import KeyGenerator

        kgen = KeyGenerator(self.params)
        sk_sparse = kgen.gen_secret_key(
            gen, dist=Ternary(hamming_weight=self.btp.ephemeral_secret_weight))
        return BootstrappingKeys(
            evk_dense_to_sparse=kgen.gen_evaluation_key(gen, sk, sk_sparse),
            evk_sparse_to_dense=kgen.gen_evaluation_key(gen, sk_sparse, sk),
        )

    def galois_elements(self) -> list[int]:
        return self.dft.galois_elements()

    def galois_element_levels(self) -> dict[int, int]:
        """gal_el → required key level (see DFTEvaluator
        .galois_element_levels) — pass to gen_galois_keys(levels=...)."""
        return self.dft.galois_element_levels()

    @property
    def minimum_input_level(self) -> int:
        """Lowest level a ciphertext may have on entry (ref
        bootstrapping/bootstrapper.go MinimumInputLevel). In the standard
        order ScaleDown brings the input to level 0 regardless, so any
        level is acceptable; in the slim order the input must still cover
        the SlotsToCoeffs matrices."""
        if self.btp.circuit_order == DECODE_THEN_MODUP:
            return self.level_s2c_top
        return 0

    @property
    def output_level(self) -> int:
        """Level of the bootstrapped output (ref OutputLevel)."""
        if self.btp.circuit_order == DECODE_THEN_MODUP:
            return self.level_mod1_top - self._mod1_depth(self.btp.mod1)
        return self.level_s2c_top - len(self.btp.s2c_levels)

    # -- stages ----------------------------------------------------------------

    def _scale_down_factor(self, level: int, scale):
        """(integer scale-up, current message ratio) of ScaleDown at
        (level, scale)."""
        mr = Fraction(2) ** self.btp.mod1.log_message_ratio
        cur_ratio = Fraction(self.params.q_big_int(level)) / Fraction(scale)
        return int(cur_ratio / mr + Fraction(1, 2)), cur_ratio

    def scale_down_label(self, level: int, scale) -> Fraction:
        """Δ₀ that :meth:`scale_down` produces from (level, scale) — pure
        metadata."""
        s_int, _ = self._scale_down_factor(level, scale)
        s = Fraction(scale) * max(s_int, 1)
        for l in range(level, 0, -1):
            s /= Fraction(self.params.q_moduli[l])
        return s

    def scale_down(self, ct: Ciphertext) -> Ciphertext:
        """Bring the ciphertext to level 0 at scale Δ₀ ≈ q0/2^log_message_ratio
        (ref ScaleDown :566): multiplies by round((Q_l/Δ)/(q0/2^mr)) — pinning
        the message ratio the Mod1 approximation was generated for — then
        rescales to level 0. Exact-Fraction labels keep the (tiny) rounding
        drift visible to the final relabel."""
        ev = self.ev
        s_int, cur_ratio = self._scale_down_factor(ct.level, ct.scale)
        if s_int < 1:
            raise ValueError(
                f"initial Q/scale = 2^{float(np.log2(float(cur_ratio))):.1f} "
                f"below the target message ratio 2^{self.btp.mod1.log_message_ratio}"
                " — lower log_message_ratio or the input scale")
        if s_int > 1:
            ct = ev.scale_up(ct, s_int)
        while ct.level > 0:
            ct = ev.rescale(ct)
        return ct

    def mod_up(self, ct: Ciphertext) -> Ciphertext:
        """Centered lift of a level-0 ct into the full chain (ref :616).

        Residues are int64 tensors carrying u64 patterns; every value
        compared here is below q0 < 2^61, where the signed order is the
        unsigned one (see :mod:`lattigo_tpu_torch.ring.modops`)."""
        p = self.params
        L = p.max_level
        q0 = p.q_moduli[0]
        v = ct.value
        if ct.is_ntt:
            v = p.ring_q.intt(v, 0)
        x = v[..., 0, :]  # [..., d+1, N] residues mod q0 (limb axis squeezed)
        q = p.ring_q.q[: L + 1]
        bhi = p.ring_q.bred_hi[: L + 1]
        xb = x[..., None, :]
        pos = modops.bred_add(xb, q, bhi)
        neg_mag = modops.bred_add(q0 - xb, q, bhi)
        neg = torch.where(neg_mag == 0, neg_mag, q - neg_mag)
        lifted = torch.where(xb > (q0 >> 1), neg, pos)
        lifted = p.ring_q.ntt(lifted, L)
        # relabel scale to q0: slot values become m/q0 + I
        out = ct.replace(value=lifted, is_ntt=True, scale=Fraction(q0))
        # Amplify the payload toward the EvalMod working scale (exact
        # integer multiply — ref evaluator.go:709; see __init__): must
        # happen HERE, before the sparse→dense switch in the caller, so
        # that even that key-switch noise is suppressed by the factor.
        if self._modup_scalar > 1:
            out = self.ev.scale_up(out, self._modup_scalar)
        return out

    def slots_to_coeffs(self, ct: Ciphertext,
                        ct_im: Ciphertext | None = None) -> Ciphertext:
        """Homomorphic decoding stage (ref bootstrapper.go SlotsToCoeffs);
        with ``ct_im=None`` the single complex ciphertext is transformed
        directly. Public so the slim order can interleave a
        coefficient-domain circuit (ref slim example step 1)."""
        if ct.level > self.level_s2c_top:
            ct = ct.at_level(self.level_s2c_top)
        if ct_im is not None and ct_im.level > self.level_s2c_top:
            ct_im = ct_im.at_level(self.level_s2c_top)
        return self.dft.slots_to_coeffs(ct, ct_im)

    def coeffs_to_slots(self, ct: Ciphertext):
        """Homomorphic encoding stage (ref bootstrapper.go CoeffsToSlots).

        When the mod1 working scale is pinned, the outputs are RELABELED to
        2^log_scale (exact metadata division that undoes the anticipation
        factor folded into the C2S matrices — ref EvaluateAndScaleNew's
        ``res.Scale = evm.ScalingFactor()``, mod1_evaluator.go:46)."""
        ct_re, ct_im = self.dft.coeffs_to_slots(ct)
        if self._mod1_scale is not None:
            ct_re = ct_re.replace(scale=self._mod1_scale)
            ct_im = ct_im.replace(scale=self._mod1_scale)
        return ct_re, ct_im

    def eval_mod(self, ct: Ciphertext) -> Ciphertext:
        """Homomorphic modular reduction stage (ref bootstrapper.go
        EvalMod). Expects CoeffsToSlots output (the interval map was
        folded into the C2S matrices)."""
        return self.mod1.evaluate(ct, pre_mapped=True)

    # -- full pipeline ------------------------------------------------------------

    def bootstrap(self, ct: Ciphertext,
                  keys: BootstrappingKeys | None = None,
                  on_stage=None) -> Ciphertext:
        """ref Bootstrap:219 / bootstrap:518: :meth:`pre`, C2S, EvalMod on
        both halves, S2C, then the q0 relabel.

        ``on_stage(name, ct)``, when given, is called after each stage with
        its output: "pre", "c2s re", "c2s im", "mod1 re", "mod1 im" and
        "out" (the relabeled result), e.g. to time or inspect the stages."""
        ev = self.ev
        p = self.params
        mark = on_stage or (lambda name, c: None)
        slim = self.btp.circuit_order == DECODE_THEN_MODUP
        if slim:
            # slim order (ref DecodeThenModUp): decode first, so the
            # message sits in the coefficients before the modulus raise.
            with span("btp.s2c"):
                ct = self.slots_to_coeffs(ct)
            mark("s2c", ct)
        with span("btp.scaledown"):
            ct0 = self.scale_down(ct)
            delta0 = Fraction(ct0.scale)
            q0 = Fraction(p.q_moduli[0])

            self._debug("scale_down", ct0)
            if keys is not None and keys.evk_dense_to_sparse is not None:
                ct0 = ev.apply_evaluation_key(ct0, keys.evk_dense_to_sparse)
            up = self.mod_up(ct0)
            if keys is not None and keys.evk_sparse_to_dense is not None:
                up = ev.apply_evaluation_key(up, keys.evk_sparse_to_dense)
        self._debug("mod_up", up)
        mark("pre", up)
        with span("btp.c2s"):
            ct_re, ct_im = self.coeffs_to_slots(up)
        self._debug("coeffs_to_slots re", ct_re)
        self._debug("coeffs_to_slots im", ct_im)
        mark("c2s re", ct_re)
        mark("c2s im", ct_im)
        with span("btp.evalmod"):
            ct_re = self.mod1.evaluate(ct_re, pre_mapped=True)
            mark("mod1 re", ct_re)
            ct_im = self.mod1.evaluate(ct_im, pre_mapped=True)
        mark("mod1 im", ct_im)
        self._debug("eval_mod re", ct_re)
        self._debug("eval_mod im", ct_im)
        if slim:
            # already in the slots domain: recombine the halves (ref slim
            # example step 6: Mul(imag, 1i); Add(real, imag)).
            out = ev.add(ct_re, ev.mul_by_i(ct_im))
        else:
            with span("btp.s2c"):
                out = self.dft.slots_to_coeffs(ct_re, ct_im)
        # undo the q0 relabel: poly = Δ'·m/q0 → scale = Δ'·Δ₀/q0
        out = out.replace(scale=Fraction(out.scale) * delta0 / q0)
        self._debug("slots_to_coeffs (final)", out)
        mark("out", out)
        return out

    def bootstrap_meta(self, ct: Ciphertext, iterations: int = 2,
                       log_prec: int = 8,
                       keys: BootstrappingKeys | None = None) -> Ciphertext:
        """META-BTS: iterate bootstrapping on the residual error to gain
        ~log_prec bits per extra iteration (ia.cr/2022/024; ref
        bootstrapping/evaluator.go:315-460 IterationsParameters).

        Round i (i = 1, 2, ...) re-bootstraps diff = (ct − out)·2^(i·log_prec)
        — the VALUE is multiplied up (exact, level-free) so the residual
        error, ~log_prec bits smaller after each round, becomes a message
        of the same size every round and the bootstrap's fixed absolute
        precision applies to it undiminished; the correction's scale is
        then relabeled ×2^(i·log_prec) so it folds back at error units.
        Round 1 is the JAX package's; from round 2 on the JAX package
        keeps the factor 2^log_prec, which leaves the residual below the
        bootstrap's own error, so a third iteration gains nothing there
        (ROADMAP, reference caveat 12).
        """
        ev = self.ev
        out = self.bootstrap(ct, keys)
        for i in range(1, iterations):
            down = out.at_level(0)
            diff = ev.sub(ct, down)                      # −err at ct.scale
            # amplify the error into the message range
            diff = ev.mul_scalar_int(diff, 1 << (i * log_prec))
            corr = self.bootstrap(diff, keys)
            # relabel so corr reads in error units, then fold into out
            corr = corr.replace(
                scale=Fraction(corr.scale) * (1 << (i * log_prec)))
            out = ev.add(out.at_level(min(out.level, corr.level)),
                         corr.at_level(min(out.level, corr.level)))
        return out

    def bootstrap_many(self, cts: list[Ciphertext],
                       keys: BootstrappingKeys | None = None,
                       log_slots: int | None = None) -> list[Ciphertext]:
        """Batch bootstrap (ref BootstrapMany:229). Full-slot ciphertexts
        are bootstrapped one by one. SPARSE ciphertexts (``log_slots`` <
        log_max_slots: slots replicated 2^g times, so coefficients sit at
        stride 2^g, g = log_max_slots − log_slots) are interleaved in groups
        of up to 2^g into one full ciphertext by the ring-packing tree,
        bootstrapped once and unpacked (ref PackAndSwitchN1ToN2 /
        UnpackAndSwitchN2ToN1; the tree's Galois elements are
        :meth:`packing_galois_elements`)."""
        from lattigo_tpu_torch.rlwe.ring_packing import RingPackingEvaluator
        p = self.params
        if log_slots is None or (1 << log_slots) >= p.max_slots:
            return [self.bootstrap(c, keys) for c in cts]
        rp = RingPackingEvaluator(self.ev)
        g = p.max_slots.bit_length() - 1 - log_slots
        out: list[Ciphertext] = []
        for lo in range(0, len(cts), 1 << g):
            # pack at the minimum input level, so the pack tree's Galois
            # keys can stay level-scoped
            grp = [c.at_level(self.minimum_input_level)
                   if c.level > self.minimum_input_level else c
                   for c in cts[lo: lo + (1 << g)]]
            packed = rp.pack(dict(enumerate(grp)), input_log_gap=g)
            boot = self.bootstrap(packed, keys)
            out.extend(rp.unpack(boot, g)[: len(grp)])
        return out

    def evaluate_conjugate_invariant(
            self, ct_left: Ciphertext, ct_right: Ciphertext | None = None,
            switcher=None, keys: BootstrappingKeys | None = None):
        """Bootstrap one or two conjugate-invariant-ring ciphertexts with
        one standard-ring bootstrap (ref EvaluateConjugateInvariant,
        bootstrapping/evaluator.go:460): they are bridged to the standard
        2N ring, packed as the real and imaginary halves of one complex
        ciphertext, bootstrapped once and split back.

        ``switcher`` is a :class:`~lattigo_tpu_torch.schemes.ckks.bridge
        .DomainSwitcher` whose standard side is this evaluator's
        parameters. Returns (ct_left', ct_right' or None) in the CI ring at
        the bootstrap's output level; the exact Fraction scales absorb the
        conjugation fold's factor 2."""
        if switcher is None:
            raise ValueError("evaluate_conjugate_invariant needs a DomainSwitcher")
        ev = self.ev
        up = switcher.real_to_complex(ct_left)
        if ct_right is not None:
            up = ev.add(up, ev.mul_by_i(switcher.real_to_complex(ct_right)))
        out = self.bootstrap(up, keys)
        left = switcher.complex_to_real(out)
        right = None
        if ct_right is not None:
            # Re(−i·m) = Im(m): the imaginary half
            right = switcher.complex_to_real(ev.mul_by_minus_i(out))
        return left, right

    def packing_galois_elements(self, log_slots: int) -> dict[int, int]:
        """gal_el → level of the sparse :meth:`bootstrap_many`'s pack /
        unpack tree (pack runs at the minimum input level, unpack at the
        output level), for ``gen_galois_keys(..., levels=...)``."""
        from lattigo_tpu_torch.rlwe.ring_packing import RingPackingEvaluator
        p = self.params
        rp = RingPackingEvaluator(self.ev)
        g = p.max_slots.bit_length() - 1 - log_slots
        lvls: dict[int, int] = {}
        for el in rp.galois_elements_for_pack(log_start=p.log_n - g):
            lvls[el] = max(lvls.get(el, 0), self.minimum_input_level)
        for el in rp.galois_elements_for_unpack(g):
            lvls[el] = max(lvls.get(el, 0), self.output_level)
        return lvls


class CircuitBootstrapper:
    """A :class:`BootstrappingEvaluator` behind the interface the circuits
    call (``bootstrap(ct)``, ``minimum_input_level``, ``counter``): the real
    counterpart of :class:`SecretKeyBootstrapper`, for the minimax
    composite, comparison and inverse evaluators.

    It holds the encapsulation keys the pipeline takes, and brings each
    output to the parameters' default scale with one
    :meth:`~lattigo_tpu_torch.schemes.ckks.Evaluator.set_scale` (a level).
    The pipeline ends at scale Δ'·Δ₀/q₀ (2^52 at ``N16QP1546_H192_H32``,
    whose default scale is 2^40), and a polynomial stage on such an input
    encodes its constants at target·q/σ(T_k) < 1, where they round away:
    an X4 stage after a bootstrap keeps 4 of its 19 bits at logN 8 without
    the set_scale. ``minimum_input_level`` (0 unless raised, as the
    secret-key bootstrapper's) is what the circuits plan their bootstraps
    by; ``InverseEvaluator.evaluate_full_domain`` needs 1.
    """

    def __init__(self, evaluator: BootstrappingEvaluator,
                 keys: BootstrappingKeys | None = None,
                 minimum_input_level: int | None = None):
        self.evaluator = evaluator
        self.keys = keys
        self.counter = 0
        self._min_level = (evaluator.minimum_input_level if minimum_input_level is None
                           else minimum_input_level)

    @property
    def minimum_input_level(self) -> int:
        return self._min_level

    def bootstrap(self, ct: Ciphertext) -> Ciphertext:
        out = self.evaluator.bootstrap(ct, self.keys)
        self.counter += 1
        scale = self.evaluator.params.default_scale_fraction
        if Fraction(out.scale) != scale:
            out = self.evaluator.ev.set_scale(out, scale)
        return out


class SecretKeyBootstrapper:
    """Debug decrypt-then-reencrypt "bootstrapper" (ref
    bootstrapping/sk_bootstrapper.go:68): implements the same interface as
    :class:`BootstrappingEvaluator` but refreshes by decrypting with the
    secret key, re-encoding at the top level, and re-encrypting with
    randomness from ``gen``. Use it to test level-hungry circuits without
    paying for real bootstrapping; ``counter`` records how many bootstraps
    the circuit consumed.

    ``minimum_input_level`` (0, as in the reference) is what it reports to
    circuits that plan their bootstraps by it (the minimax composite
    evaluator). Raise it where a composite's output must stay above level
    0: ``InverseEvaluator.evaluate_full_domain`` multiplies by its sign
    without bootstrapping it.
    """

    def __init__(self, params, encoder, sk, gen: torch.Generator,
                 minimum_input_level: int = 0):
        from lattigo_tpu_torch.rlwe.encryption import Decryptor, Encryptor

        self.params = params
        self.encoder = encoder
        self.dec = Decryptor(params, sk)
        self.enc = Encryptor(params, sk)
        self.gen = gen
        self.counter = 0
        self._min_level = minimum_input_level

    @property
    def minimum_input_level(self) -> int:
        return self._min_level

    @property
    def output_level(self) -> int:
        return self.params.max_level

    def bootstrap(self, ct: Ciphertext) -> Ciphertext:
        values = self.encoder.decode(self.dec.decrypt(ct))
        pt = self.encoder.encode(values)
        self.counter += 1
        return self.enc.encrypt(self.gen, pt)

    def bootstrap_many(self, cts: list[Ciphertext]) -> list[Ciphertext]:
        return [self.bootstrap(c) for c in cts]
