"""Parameter presets.

``bgv_tpu_params`` builds a BGV budget of a given logQP from 28-bit primes
(< 2^29), so every NTT of ring Q, ring P and ring T takes the four-step
digit-matmul engine.
"""

from __future__ import annotations

from lattigo_tpu_torch.schemes import bgv

T_DEFAULT = 0x10001  # 65537


def bgv_tpu_params(log_n: int, log_qp: int, t: int = T_DEFAULT,
                   log_p_count: int = 2) -> bgv.ParametersLiteral:
    """Same-logQP BGV budget built from 28-bit primes."""
    n_total = log_qp // 28
    n_p = max(1, log_p_count)
    return bgv.ParametersLiteral(
        log_n=log_n, log_q=(28,) * (n_total - n_p), log_p=(28,) * n_p, t=t)
