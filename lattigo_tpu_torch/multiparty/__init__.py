"""Multiparty / threshold HE protocols.

Counterpart of :mod:`lattigo_tpu.multiparty`: collective key generation
(public, relinearization, Galois and generic evaluation keys), collective
key switching (CKS, PCKS), encryption ↔ share conversion and refresh, and
t-out-of-N Shamir thresholdization. Carrying shares between parties is the
application's job; shares are plain tensors and dataclasses.
"""

from lattigo_tpu_torch.multiparty.protocols import (
    PublicKeyGenProtocol, KeySwitchProtocol, PublicKeySwitchProtocol,
    GaloisKeyGenProtocol, RelinearizationKeyGenProtocol,
    EvaluationKeyGenProtocol,
    NoiseFlooding, sample_crp_qp,
)
from lattigo_tpu_torch.multiparty.threshold import (
    Thresholdizer, Combiner, ShamirPolynomial,
)
from lattigo_tpu_torch.multiparty.additive_shares import (
    AdditiveShare, AdditiveShareBigint,
    new_additive_share, new_additive_share_bigint,
)
from lattigo_tpu_torch.multiparty.sharing_bgv import (
    BGVEncToShareProtocol, BGVShareToEncProtocol,
    BGVMaskedTransformProtocol, BGVRefreshProtocol, MaskedTransformFunc,
)

__all__ = [
    "PublicKeyGenProtocol", "KeySwitchProtocol", "PublicKeySwitchProtocol",
    "EvaluationKeyGenProtocol",
    "GaloisKeyGenProtocol", "RelinearizationKeyGenProtocol",
    "NoiseFlooding", "sample_crp_qp",
    "Thresholdizer", "Combiner", "ShamirPolynomial",
    "BGVEncToShareProtocol", "BGVShareToEncProtocol",
    "BGVMaskedTransformProtocol", "BGVRefreshProtocol", "MaskedTransformFunc",
]
