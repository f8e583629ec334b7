"""Parameter presets.

The BGV (regular and scale-invariant), CKKS complex-slot and real-slot
(conjugate-invariant ring) sets of the reference's examples (logQP
budgets of the homomorphic-encryption.org tables for ternary secrets at
128-bit security; primes drawn NTT-friendly at construction).
``bgv_tpu_params`` and ``ckks_tpu_params`` build a budget of a given logQP
from 28-bit primes (< 2^29), so every NTT of rings Q, P (and T) at
4096 ≤ N ≤ 65536 takes the four-step digit-matmul engine.
"""

from __future__ import annotations

from lattigo_tpu_torch.ring.ring import CONJUGATE_INVARIANT
from lattigo_tpu_torch.schemes import bgv, ckks

T_DEFAULT = 0x10001  # 65537

# -- BGV (regular tensoring: mul then rescale) ---------------------------------

BGV_PARAMS_N12_QP109 = bgv.ParametersLiteral(
    log_n=12, log_q=(39, 31), log_p=(39,), t=T_DEFAULT)
BGV_PARAMS_N13_QP218 = bgv.ParametersLiteral(
    log_n=13, log_q=(42, 33, 33, 33, 33), log_p=(44,), t=T_DEFAULT)
BGV_PARAMS_N14_QP438 = bgv.ParametersLiteral(
    log_n=14, log_q=(44,) + (34,) * 9, log_p=(44, 44), t=T_DEFAULT)
BGV_PARAMS_N15_QP880 = bgv.ParametersLiteral(
    log_n=15, log_q=(47,) + (34,) * 19, log_p=(47,) * 4, t=T_DEFAULT)

# -- BGV scale-invariant (BFV-style mul_scale_invariant) -----------------------

BGV_SI_PARAMS_N12_QP109 = bgv.ParametersLiteral(
    log_n=12, log_q=(39, 39), log_p=(31,), t=T_DEFAULT)
BGV_SI_PARAMS_N13_QP218 = bgv.ParametersLiteral(
    log_n=13, log_q=(55, 54, 54), log_p=(55,), t=T_DEFAULT)
BGV_SI_PARAMS_N14_QP438 = bgv.ParametersLiteral(
    log_n=14, log_q=(55, 55, 55, 54, 54, 54), log_p=(56, 55), t=T_DEFAULT)
BGV_SI_PARAMS_N15_QP880 = bgv.ParametersLiteral(
    log_n=15, log_q=(60, 60, 59) + (58,) * 9, log_p=(60,) * 3, t=T_DEFAULT)

# -- CKKS over C^{N/2} --------------------------------------------------------

CKKS_COMPLEX_PARAMS_N12_QP109 = ckks.ParametersLiteral(
    log_n=12, log_q=(38, 32), log_p=(39,), log_default_scale=32)
CKKS_COMPLEX_PARAMS_N13_QP218 = ckks.ParametersLiteral(
    log_n=13, log_q=(33,) + (30,) * 5, log_p=(35,), log_default_scale=30)
CKKS_COMPLEX_PARAMS_N14_QP438 = ckks.ParametersLiteral(
    log_n=14, log_q=(45,) + (34,) * 9, log_p=(44, 43), log_default_scale=34)
CKKS_COMPLEX_PARAMS_N15_QP881 = ckks.ParametersLiteral(
    log_n=15, log_q=(51,) + (40,) * 17, log_p=(50,) * 3, log_default_scale=40)
CKKS_COMPLEX_PARAMS_N16_QP1761 = ckks.ParametersLiteral(
    log_n=16, log_q=(56,) + (45,) * 33, log_p=(55,) * 4, log_default_scale=45)

# -- CKKS over R^N (conjugate-invariant ring) ----------------------------------

CKKS_REAL_PARAMS_N12_QP109 = ckks.ParametersLiteral(
    log_n=12, log_q=(38, 32), log_p=(39,), log_default_scale=32,
    ring_type=CONJUGATE_INVARIANT)
CKKS_REAL_PARAMS_N13_QP218 = ckks.ParametersLiteral(
    log_n=13, log_q=(33,) + (30,) * 5, log_p=(35,), log_default_scale=30,
    ring_type=CONJUGATE_INVARIANT)
CKKS_REAL_PARAMS_N14_QP438 = ckks.ParametersLiteral(
    log_n=14, log_q=(46,) + (34,) * 9, log_p=(43, 43), log_default_scale=34,
    ring_type=CONJUGATE_INVARIANT)
CKKS_REAL_PARAMS_N15_QP881 = ckks.ParametersLiteral(
    log_n=15, log_q=(51,) + (40,) * 17, log_p=(50,) * 3, log_default_scale=40,
    ring_type=CONJUGATE_INVARIANT)
CKKS_REAL_PARAMS_N16_QP1761 = ckks.ParametersLiteral(
    log_n=16, log_q=(56,) + (45,) * 33, log_p=(55,) * 4, log_default_scale=45,
    ring_type=CONJUGATE_INVARIANT)

BGV_PARAMS = [BGV_PARAMS_N12_QP109, BGV_PARAMS_N13_QP218,
              BGV_PARAMS_N14_QP438, BGV_PARAMS_N15_QP880]
BGV_SI_PARAMS = [BGV_SI_PARAMS_N12_QP109, BGV_SI_PARAMS_N13_QP218,
                 BGV_SI_PARAMS_N14_QP438, BGV_SI_PARAMS_N15_QP880]
CKKS_COMPLEX_PARAMS = [
    CKKS_COMPLEX_PARAMS_N12_QP109, CKKS_COMPLEX_PARAMS_N13_QP218,
    CKKS_COMPLEX_PARAMS_N14_QP438, CKKS_COMPLEX_PARAMS_N15_QP881,
    CKKS_COMPLEX_PARAMS_N16_QP1761]
CKKS_REAL_PARAMS = [
    CKKS_REAL_PARAMS_N12_QP109, CKKS_REAL_PARAMS_N13_QP218,
    CKKS_REAL_PARAMS_N14_QP438, CKKS_REAL_PARAMS_N15_QP881,
    CKKS_REAL_PARAMS_N16_QP1761]


def bgv_tpu_params(log_n: int, log_qp: int, t: int = T_DEFAULT,
                   log_p_count: int = 2) -> bgv.ParametersLiteral:
    """Same-logQP BGV budget built from 28-bit primes."""
    n_total = log_qp // 28
    n_p = max(1, log_p_count)
    return bgv.ParametersLiteral(
        log_n=log_n, log_q=(28,) * (n_total - n_p), log_p=(28,) * n_p, t=t)


def ckks_tpu_params(log_n: int, log_qp: int, log_default_scale: int = 28,
                    log_p_count: int = 2) -> ckks.ParametersLiteral:
    """Same-logQP CKKS budget built from 28-bit primes (scale 2^28 a level)."""
    n_total = log_qp // 28
    n_p = max(1, log_p_count)
    return ckks.ParametersLiteral(
        log_n=log_n, log_q=(28,) * (n_total - n_p), log_p=(28,) * n_p,
        log_default_scale=log_default_scale)
