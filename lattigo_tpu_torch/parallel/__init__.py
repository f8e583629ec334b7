"""Multi-device execution over ``torch.distributed``.

Counterpart of :mod:`lattigo_tpu.parallel` (SPMD over a JAX mesh). The
reference has no distributed backend; its parallel axes map to ranks as:

* ``dp``   — ciphertext batch: each rank runs the ordinary evaluator on
  its rows (the bootstrap too; :func:`.spmd.bootstrap_many`).
* ``limb`` — RNS limbs: NTTs and elementwise ops run on the rank's limbs;
  basis extension, ModDown and rescale contract over limbs and gather
  what they read (:class:`.spmd.LimbShardedEvaluator`).
* ``sp``   — coefficients (:mod:`.ntt_sp`): the NTT's first / last
  log2(D) butterfly stages become pairwise exchanges, bit-exact vs the
  one-process NTT.

Ranks are processes (:mod:`.launch`); :mod:`.dryrun` is the multichip dry
run.
"""

from lattigo_tpu_torch.parallel.mesh import (
    Mesh, batch_sharding, gather_ciphertext, make_mesh, shard_ciphertext,
)
from lattigo_tpu_torch.parallel.ntt_sp import (
    gather_coefficients, intt_sharded, negacyclic_mul_sharded, ntt_sharded,
    shard_coefficients,
)
from lattigo_tpu_torch.parallel.spmd import LimbShardedEvaluator

__all__ = ["make_mesh", "shard_ciphertext", "batch_sharding",
           "ntt_sharded", "intt_sharded", "negacyclic_mul_sharded",
           "Mesh", "gather_ciphertext", "shard_coefficients",
           "gather_coefficients", "LimbShardedEvaluator"]
