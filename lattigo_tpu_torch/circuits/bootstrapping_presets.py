"""Published default CKKS bootstrapping parameter sets.

Counterpart of :mod:`lattigo_tpu.circuits.bootstrapping_presets`, the same
literals and the same chain builder. Transcription of the reference's 4
sparse + 4 dense default sets
(ref circuits/ckks/bootstrapping/default_parameters.go:20-196, ia.cr/2022/024
sparse-secret encapsulation) into this library's parameterization, plus the
builder that stitches the *residual* parameters and the bootstrapping
literal into the full modulus chain (ref bootstrapping/parameters.go:51
NewParametersFromLiteral).

Chain layout (bottom -> top), as consumed by
:class:`~lattigo_tpu_torch.circuits.bootstrapping.BootstrappingEvaluator`:

    q0 | residual levels | SlotsToCoeffs | EvalMod | CoeffsToSlots

Deviations from the reference:

* factorization entries holding several scales (e.g. ``{30, 30}`` — one
  matrix rescaled by two 30-bit primes) become SEPARATE levels of one prime
  each (``[[30, 30]] → [[30], [30]]``), since the evaluator consumes one
  prime per linear-transform level. Total consumed modulus bits and logQP
  are identical; what changes is the DFT merge depth: the reference's
  depth-1 variants merge all log(slots) butterfly stages into ONE dense
  matrix with ~2·slots nonzero diagonals (dft.go:698 ``merge[0] =
  logSlots``) — at logN=15 that is ~2^15 encoded diagonals over the whole
  chain, beyond one card's memory (the reference pays it in host RAM);
  splitting into two matrices of ~√slots diagonals each costs the same
  primes and needs 2^7 + 2^8 − 1 diagonals per transform.
* depth accounting matches the reference exactly: C2S/S2C consume one
  prime per factorization level, EvalMod consumes Depth() = bit_length(
  max(degree, 2K−1)) + DoubleAngle (+ arcsine) primes — the interval map
  and the conjugation split are free scale-metadata changes and the P-S
  evaluation is depth-exact (see circuits/polynomial.py recursePS notes).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from lattigo_tpu_torch.circuits.bootstrapping import (
    BootstrappingEvaluator, BootstrappingParameters,
)
from lattigo_tpu_torch.circuits.mod1 import COS_DISCRETE, Mod1Parameters
from lattigo_tpu_torch.ring.sampling import Ternary
from lattigo_tpu_torch.schemes import ckks


@dataclass
class BootstrappingLiteral:
    """All-optional bootstrapping literal (ref parameters_literal.go:15).

    ``s2c_log_scales`` / ``c2s_log_scales``: one inner list per
    linear-transform level, holding the log2 scales consumed by that level
    (ref SlotsToCoeffs/CoeffsToSlotsFactorizationDepthAndLogScales).

    ``mod1_k`` and ``ephemeral_secret_weight`` are coupled: the mod-up lift
    integers are an Irwin–Hall sum of ``H`` signed uniforms whose SUPPORT is
    exactly ±H/2, so the default K=16 is the hard bound of an H=32 secret
    (the reference's 2^-138.7 failure probability is the corner volume of
    that sum near ±16, parameters_literal.go:27). Disabling encapsulation
    (``ephemeral_secret_weight=None``) under a denser main secret makes |I|
    overflow K on a few slots per ciphertext and silently costs the whole
    output's max-error precision — keep K ≥ H/2 of whichever secret is live
    during ModUp.
    """

    c2s_log_scales: list[list[int]] = field(
        default_factory=lambda: [[56], [56], [56], [56]])
    s2c_log_scales: list[list[int]] = field(
        default_factory=lambda: [[39], [39], [39]])
    evalmod_log_scale: int = 60
    log_message_ratio: int = 8
    mod1_k: int = 16
    mod1_degree: int = 30
    mod1_double_angle: int = 3
    mod1_type: str = COS_DISCRETE
    mod1_inv_degree: int = 0
    ephemeral_secret_weight: int | None = 32


def _radix_split(log_slots: int, n_levels: int) -> list[int]:
    """Split log_slots into n_levels radix factors, largest first
    (ref dft.go:163 NewMatrixFromLiteral level allocation)."""
    base, rem = divmod(log_slots, n_levels)
    return [base + (1 if i < rem else 0) for i in range(n_levels)]


def build_bootstrapping_parameters(
    residual: ckks.ParametersLiteral,
    lit: BootstrappingLiteral | None = None,
) -> tuple[ckks.ParametersLiteral, BootstrappingParameters]:
    """(full-chain CKKS literal, evaluator parameters) from residual params
    + bootstrapping literal (ref bootstrapping/parameters.go:51)."""
    lit = BootstrappingLiteral() if lit is None else lit
    # Mod1Parameters.log_scale = the reference's EvalModLogScale working-
    # scale pinning, and it is NOT optional for precision: the Chebyshev
    # squaring ladder maps scale σ → σ²/q whose fixed point is q, so an
    # EvalMod input scale below the ≈2^evalmod_log_scale chain primes makes
    # the power-basis scales collapse geometrically until RLWE noise is
    # message-sized (see mod1.Mod1Evaluator.evaluate). Exact-Fraction
    # labels make the pin itself free (one metadata relabel after C2S plus
    # the anticipation factor folded into the C2S constants).
    # the secret live during ModUp sets the lift-integer distribution the
    # DC-debias averages over (see Mod1Parameters.debias_weight)
    live_h = (lit.ephemeral_secret_weight
              or getattr(residual.xs, "hamming_weight", None))
    mod1 = Mod1Parameters(
        k=lit.mod1_k, degree=lit.mod1_degree,
        double_angle=lit.mod1_double_angle,
        log_message_ratio=lit.log_message_ratio,
        arcsine_degree=lit.mod1_inv_degree,
        mod1_type=lit.mod1_type,
        log_scale=lit.evalmod_log_scale,
        debias_weight=live_h)
    n_evalmod = BootstrappingEvaluator._mod1_depth(mod1)
    s2c = [sum(level) for level in lit.s2c_log_scales]
    c2s = [sum(level) for level in lit.c2s_log_scales]
    log_q = (tuple(residual.log_q) + tuple(s2c)
             + (lit.evalmod_log_scale,) * n_evalmod + tuple(c2s))
    full = replace(residual, log_q=log_q)

    log_slots = residual.log_n - 1  # full-slot bootstrapping
    btp = BootstrappingParameters(
        c2s_levels=_radix_split(log_slots, len(c2s)),
        s2c_levels=_radix_split(log_slots, len(s2c)),
        mod1=mod1,
        residual_levels=len(residual.log_q) - 1,
        ephemeral_secret_weight=lit.ephemeral_secret_weight,
    )
    return full, btp


# -- the 8 published sets (ref default_parameters.go:20-196) -----------------
# name -> (residual ckks literal, bootstrapping literal)

# Sparse main secret H=192 (+ H=32 ephemeral).
N16QP1546_H192_H32 = (
    ckks.ParametersLiteral(
        log_n=16, log_q=(60,) + (40,) * 9, log_p=(61,) * 5,
        xs=Ternary(hamming_weight=192), log_default_scale=40),
    BootstrappingLiteral(),                       # 26.6 bits @ 2^15 slots
)
N16QP1547_H192_H32 = (
    ckks.ParametersLiteral(
        log_n=16, log_q=(60,) + (45,) * 5, log_p=(61,) * 4,
        xs=Ternary(hamming_weight=192), log_default_scale=45),
    BootstrappingLiteral(                         # 32.1 bits @ 2^15 slots
        s2c_log_scales=[[42], [42], [42]],
        c2s_log_scales=[[58], [58], [58], [58]],
        log_message_ratio=2, mod1_inv_degree=7),
)
N16QP1553_H192_H32 = (
    ckks.ParametersLiteral(
        log_n=16, log_q=(55,) + (60,) * 7, log_p=(61,) * 5,
        xs=Ternary(hamming_weight=192), log_default_scale=30),
    BootstrappingLiteral(                         # 19.1 bits @ 2^15 slots
        # ref: [[30], [30, 30]] — second level split, see module doc
        s2c_log_scales=[[30], [30], [30]],
        c2s_log_scales=[[53], [53], [53], [53]],
        evalmod_log_scale=55),
)
N15QP768_H192_H32 = (
    ckks.ParametersLiteral(
        log_n=15, log_q=(33, 50, 25), log_p=(51,) * 2,
        xs=Ternary(hamming_weight=192), log_default_scale=25),
    BootstrappingLiteral(                         # 15.4 bits @ 2^14 slots
        # ref: [[30, 30]] (one dense depth-1 matrix) — split, see module doc
        s2c_log_scales=[[30], [30]],
        c2s_log_scales=[[49], [49]],
        evalmod_log_scale=50),
)

# Dense main secret H=N/2 (+ H=32 ephemeral).
N16QP1767_H32768_H32 = (
    ckks.ParametersLiteral(
        log_n=16, log_q=(60,) + (40,) * 13, log_p=(61,) * 6,
        xs=Ternary(hamming_weight=32768), log_default_scale=40),
    BootstrappingLiteral(                         # 23.8 bits @ 2^15 slots
        s2c_log_scales=[[39], [39], [39]],
        c2s_log_scales=[[56], [56], [56], [56]],
        evalmod_log_scale=60),
)
N16QP1788_H32768_H32 = (
    ckks.ParametersLiteral(
        log_n=16, log_q=(60,) + (45,) * 9, log_p=(61,) * 5,
        xs=Ternary(hamming_weight=32768), log_default_scale=45),
    BootstrappingLiteral(                         # 29.8 bits @ 2^15 slots
        s2c_log_scales=[[42], [42], [42]],
        c2s_log_scales=[[58], [58], [58], [58]],
        log_message_ratio=2, mod1_inv_degree=7),
)
N16QP1793_H32768_H32 = (
    ckks.ParametersLiteral(
        log_n=16, log_q=(55,) + (60,) * 11 + (60, 30), log_p=(61,) * 5,
        xs=Ternary(hamming_weight=32768), log_default_scale=30),
    BootstrappingLiteral(                         # 17.8 bits @ 2^15 slots
        # ref: [[30], [30, 30]] — second level split, see module doc
        s2c_log_scales=[[30], [30], [30]],
        c2s_log_scales=[[53], [53], [53], [53]],
        evalmod_log_scale=55),
)
N15QP880_H16384_H32 = (
    ckks.ParametersLiteral(
        log_n=15, log_q=(40,) + (31,) * 4, log_p=(56,) * 2,
        xs=Ternary(hamming_weight=16384), log_default_scale=31),
    BootstrappingLiteral(                         # 17.3 bits @ 2^14 slots
        # ref: [[30, 30]] (one dense depth-1 matrix) — split, see module doc
        s2c_log_scales=[[30], [30]],
        c2s_log_scales=[[52], [52]],
        evalmod_log_scale=55),
)

def prepare_recipe(preset, log_n: int | None = None, seed: int = 0,
                   data_seed: int = 1, device=None, timed=None,
                   pack_log_slots: int | None = None, batch: int = 1) -> dict:
    """Set up a preset's exact chain/mod1/factorization at (optionally
    reduced) ring degree on ``device`` (CUDA unless named): the parameters,
    the bootstrapping evaluator with its relinearization and level-scoped
    Galois keys, the encapsulation keys, and 2^(logN-1) complex slots
    uniform in [-1, 1) + i[-1, 1) encrypted at the minimum input level.

    The keys and the encryption draw from ``torch.Generator``s seeded from
    ``seed``, one per use; the input slots from numpy's ``data_seed``.
    ``timed(label, fn)``, when given, runs each key and matrix set-up step
    as fn() and returns its result (e.g. to time it). ``pack_log_slots``
    adds the Galois keys of the sparse ``bootstrap_many``'s pack tree at
    that slot count (``packing_galois_elements``, at their levels).
    ``batch`` > 1 encrypts the slots that many times, on a leading axis of
    the ciphertext. Returns a dict with ``params``, ``evaluator``,
    ``keys``, ``galois_keys``, ``sk``, ``ct``, ``slots`` and ``decode`` (a
    bootstrapped ciphertext → its decrypted slots).
    """
    import numpy as np
    import torch
    from lattigo_tpu_torch import rlwe

    step = timed or (lambda label, fn: fn())
    residual, lit = preset
    if log_n is not None:
        residual = replace(residual, log_n=log_n)
        # dense-secret sets (H = N/2 at full degree) must shrink with the
        # ring: cap the Hamming weight at N/2 of the reduced degree
        hw = getattr(residual.xs, "hamming_weight", None)
        if hw is not None and hw > (1 << log_n) // 2:
            residual = replace(
                residual, xs=type(residual.xs)(hamming_weight=(1 << log_n) // 2))
    full, btp = build_bootstrapping_parameters(residual, lit)
    params = ckks.Parameters(full, device)
    g_sk, g_rlk, g_gk, g_ct, g_enc = (
        torch.Generator(device=params.device).manual_seed(seed * 5 + i)
        for i in range(5))
    kgen = rlwe.KeyGenerator(params)
    sk = step("secret key", lambda: kgen.gen_secret_key(g_sk))
    rlk = step("relinearization key", lambda: kgen.gen_relinearization_key(g_rlk, sk))
    enc = ckks.Encoder(params)
    b = step("DFT matrices", lambda: BootstrappingEvaluator(params, ckks.Evaluator(
        params, rlwe.EvaluationKeySet(relinearization_key=rlk)), enc, btp))
    els, levels = list(b.galois_elements()), dict(b.galois_element_levels())
    if pack_log_slots is not None:
        for g, lvl in b.packing_galois_elements(pack_log_slots).items():
            if g not in levels:
                els.append(g)
            levels[g] = max(levels.get(g, lvl), lvl)
    gks = step("Galois keys", lambda: kgen.gen_galois_keys(g_gk, els, sk, levels=levels))
    b.with_evaluator(ckks.Evaluator(params, rlwe.EvaluationKeySet(
        relinearization_key=rlk, galois_keys=gks)))
    keys = step("encapsulation keys", lambda: b.gen_encapsulation_keys(g_enc, sk))
    rng = np.random.default_rng(data_seed)
    v = (rng.uniform(-1, 1, params.max_slots)
         + 1j * rng.uniform(-1, 1, params.max_slots))
    ct = rlwe.Encryptor(params, sk).encrypt(
        g_ct, enc.encode(v), batch=(batch,) if batch > 1 else ()
    ).at_level(b.minimum_input_level)
    dec = rlwe.Decryptor(params, sk)
    return dict(params=params, evaluator=b, keys=keys, galois_keys=gks, sk=sk,
                ct=ct, slots=v, decode=lambda out: enc.decode(dec.decrypt(out)))


def precision_bits(got, want) -> tuple[float, float]:
    """(worst, mean) bits of precision of slots ``got`` against ``want``."""
    import numpy as np
    errs = np.abs(got - want)
    worst = float(-np.log2(errs.max()))
    avg = float(np.mean(-np.log2(np.maximum(errs, 2.0 ** -60))))
    return worst, avg


def run_recipe(preset, log_n: int | None = None, seed: int = 0,
               data_seed: int = 1, device=None):
    """Execute a preset's recipe (:func:`prepare_recipe`) end-to-end: one
    bootstrap of its input, called directly. Returns (worst_bits,
    avg_bits).

    The degree scales only the DFT gain and RLWE noise (~√N), so a recipe
    that is structurally broken (scale plumbing, matrix quantisation,
    message-ratio bookkeeping) is loud at logN=9.
    """
    r = prepare_recipe(preset, log_n, seed, data_seed, device)
    out = r["evaluator"].bootstrap(r["ct"], r["keys"])
    return precision_bits(r["decode"](out), r["slots"])


DEFAULT_PARAMETERS_SPARSE = [
    N16QP1546_H192_H32, N16QP1547_H192_H32, N16QP1553_H192_H32,
    N15QP768_H192_H32,
]
DEFAULT_PARAMETERS_DENSE = [
    N16QP1767_H32768_H32, N16QP1788_H32768_H32, N16QP1793_H32768_H32,
    N15QP880_H16384_H32,
]
