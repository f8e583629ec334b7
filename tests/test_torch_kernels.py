"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips where
no CUDA device exists (the CPU tier). On a machine with a card (no JAX
there), run them with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Every comparison is bit for bit (tolerance 0): the kernel and the plain
version compute the same integer function.
"""

import pytest
import torch

from lattigo_tpu_torch.presets import bgv_tpu_params
from lattigo_tpu_torch.ring import ntt_mxu
from lattigo_tpu_torch.ring.ring import Ring
from lattigo_tpu_torch.rlwe.params import gen_moduli

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ring(logn, cuda):
    lit = bgv_tpu_params(logn, 438)
    q, p = gen_moduli(logn, 2 << logn, lit.log_q, lit.log_p)
    return Ring(1 << logn, q + p, device=cuda)


def _residues(ring, batch, seed):
    g = torch.Generator(device=ring.device).manual_seed(seed)
    x = torch.randint(0, 1 << 62, batch + (len(ring.moduli), ring.n),
                      generator=g, device=ring.device)
    return x % ring.q


@pytest.mark.parametrize("logn", [12, 13, 14])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_four_step_kernel_matches_plain(cuda, logn, inverse, lazy):
    ring = _ring(logn, cuda)
    assert ring.ntt_engine == "mxu-cuda"
    eng = ring._mxu
    x = _residues(ring, (3,), logn)
    before = dict(ntt_mxu.LAUNCHES)
    got = ntt_mxu.four_step_cuda(eng, x, 0, inverse, lazy)
    key = "inverse" if inverse else "forward"
    assert ntt_mxu.LAUNCHES[key] == before[key] + 1
    want = ntt_mxu.four_step_plain(eng, x, 0, inverse, lazy)
    assert torch.equal(got, want)
    assert bool((got < (2 if lazy else 1) * ring.q).all())


@pytest.mark.parametrize("logn", [12, 14])
def test_four_step_kernel_roundtrip_and_offset(cuda, logn):
    ring = _ring(logn, cuda)
    x = _residues(ring, (2,), 100 + logn)
    y = ring.ntt(x)
    assert torch.equal(ring.intt(y), x)
    for i in (1, len(ring.moduli) - 1):
        xi = x[:, i:i + 1].contiguous()
        yi = ring.ntt_single(i, xi)
        assert torch.equal(yi, y[:, i:i + 1])
        assert torch.equal(ring.intt_single(i, yi), xi)


def test_four_step_kernel_rejects_bad_input(cuda):
    ring = _ring(12, cuda)
    eng = ring._mxu
    x = _residues(ring, (2,), 1)
    with pytest.raises(TypeError):
        ntt_mxu.four_step_cuda(eng, x.to(torch.int32), 0, False, False)
    with pytest.raises(ValueError):
        ntt_mxu.four_step_cuda(eng, x.transpose(0, 1), 0, False, False)
    with pytest.raises(ValueError):
        ntt_mxu.four_step_cuda(eng, x[..., : ring.n // 2].contiguous(), 0,
                               False, False)
    with pytest.raises(ValueError):
        ntt_mxu.four_step_cuda(eng, x, 1, False, False)
