"""Standard <-> conjugate-invariant CKKS scheme switching.

Analog of the reference's examples/singleparty/ckks_scheme_switching:
a complex-slot ciphertext in the standard ring is bridged to the
conjugate-invariant ring (real slots, half the ring degree), operated on
there, and bridged back (ref schemes/ckks/bridge.go DomainSwitcher).

    python -m lattigo_tpu_torch.examples.ckks_scheme_switching
"""

import numpy as np
import torch

from lattigo_tpu_torch import rlwe
from lattigo_tpu_torch.ring.ring import CONJUGATE_INVARIANT
from lattigo_tpu_torch.schemes import ckks
from lattigo_tpu_torch.schemes.ckks.bridge import DomainSwitcher, gen_ring_swap_keys
from lattigo_tpu_torch.schemes.ckks.encoder import CIEncoder
from lattigo_tpu_torch.utils.primes import NTTFriendlyPrimesGenerator


def main(device=None):
    # both rings must share the modulus chain (NthRoot = 4*n_ci for both)
    n_ci = 256
    gq = NTTFriendlyPrimesGenerator(50, 4 * n_ci)
    g40 = NTTFriendlyPrimesGenerator(40, 4 * n_ci)
    gp = NTTFriendlyPrimesGenerator(55, 4 * n_ci)
    q_moduli = (gq.next_alternating_prime(), g40.next_alternating_prime(),
                g40.next_alternating_prime())
    p_moduli = (gp.next_alternating_prime(),)

    params_std = ckks.Parameters(ckks.ParametersLiteral(
        log_n=9, q=q_moduli, p=p_moduli, log_default_scale=40), device=device)
    params_ci = ckks.Parameters(ckks.ParametersLiteral(
        log_n=8, q=q_moduli, p=p_moduli, log_default_scale=40,
        ring_type=CONJUGATE_INVARIANT), device=device)

    gen = torch.Generator(device=params_std.ring_q.device).manual_seed(0)
    sk_std = rlwe.KeyGenerator(params_std).gen_secret_key(gen)
    sk_ci = rlwe.KeyGenerator(params_ci).gen_secret_key(gen)
    std_to_ci, ci_to_std = gen_ring_swap_keys(gen, params_std, sk_std, sk_ci)
    sw = DomainSwitcher(params_std, params_ci, std_to_ci, ci_to_std)

    enc_std = ckks.Encoder(params_std)
    enc_ci = CIEncoder(params_ci)

    rng = np.random.default_rng(1)
    v = rng.uniform(-1, 1, params_std.max_slots) \
        + 1j * rng.uniform(-1, 1, params_std.max_slots)
    ct = rlwe.Encryptor(params_std, sk_std).encrypt(gen, enc_std.encode(v))

    # complex -> real: the CI ciphertext holds Re(v) in N real slots
    ct_ci = sw.complex_to_real(ct)
    rlk_ci = rlwe.KeyGenerator(params_ci).gen_relinearization_key(gen, sk_ci)
    ev_ci = ckks.Evaluator(params_ci,
                           rlwe.EvaluationKeySet(relinearization_key=rlk_ci))
    ct_ci = ev_ci.rescale(ev_ci.mul_relin(ct_ci, ct_ci))  # Re(v)^2, real ring

    got_re = enc_ci.decode(rlwe.Decryptor(params_ci, sk_ci).decrypt(ct_ci))
    err_ci = np.abs(got_re - np.real(v) ** 2).max()
    print(f"CI-ring square of Re(v): max err {err_ci:.2e}")

    # real -> complex: back to the standard ring
    ct_back = sw.real_to_complex(ct_ci)
    got = enc_std.decode(rlwe.Decryptor(params_std, sk_std).decrypt(ct_back))
    err = np.abs(got - np.real(v) ** 2).max()
    print(f"round trip std->CI->std:  max err {err:.2e}")


if __name__ == "__main__":
    main()
