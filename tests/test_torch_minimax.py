"""Port parity for the host minimax tables, with tolerance 0.

``remez`` on a few targets (the sigmoid of
``examples/ckks_sigmoid_minimax.py``, an interval union, an odd sign
stage), ``rebase_to_unit``, ``gen_minimax_composite_sign`` for the
schedules that contract, ``default_composite_sign_polys`` at the
reference tests' arguments, and the polynomial ``ComparisonEvaluator.step``
folds (x+1)/2 into: every coefficient equal to the JAX package's. The
schedules that fail are pinned in both packages: where the JAX package
raises the band ``ValueError`` the port raises the same; where it crashes
with a ``TypeError`` (a degree-63 first stage), the port raises a
``ValueError`` naming the stage whose Remez found no solution.
"""

import math

import numpy as np
import pytest

from lattigo_tpu.circuits import comparison as jcmp, minimax as jmm
from lattigo_tpu.utils import minimax as jmin
from lattigo_tpu_torch.circuits import comparison as tcmp, minimax as tmm
from lattigo_tpu_torch.utils import minimax as tmin

GOOD_SCHEDULES = [(6, [15, 15]), (8, [15, 15, 15]), (8, [31, 15, 15])]
BAND_SCHEDULES = [(12, [15, 15, 17, 31]), (12, [15, 15, 15, 17]), (10, [31, 31, 15]),
                  (30, [15, 15, 15, 17, 31, 31, 31, 31])]
CRASH_SCHEDULES = [(10, [63, 15, 15]), (12, [63, 31, 15])]


def _sigmoid(t):
    """The example's target: sigmoid(8t)."""
    return 1.0 / (1.0 + math.exp(-(8.0 * t)))


def _equal(got, want):
    assert (got.basis, got.interval) == (want.basis, want.interval)
    assert len(got.coeffs) == len(want.coeffs)
    for a, b in zip(got.coeffs, want.coeffs):
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("case", ["sigmoid", "union", "odd", "hull"])
def test_remez_equal(case):
    f, intervals, degree, kw = {
        "sigmoid": (_sigmoid, [(-1.0, 1.0)], 15, {}),
        "union": (np.cos, [(-2.0, -0.5), (0.25, 1.5)], 12, {}),
        "odd": (lambda x: 1.0, [(2.0 ** -6, 1.0)], 15,
                dict(odd=True, basis_interval=(-1.0, 1.0))),
        "hull": (np.exp, [(0.0, 3.0)], 10, {}),
    }[case]
    _equal(tmin.remez(f, intervals, degree, **kw), jmin.remez(f, intervals, degree, **kw))


def test_rebase_to_unit_equal():
    for f, iv in ((np.exp, (0.0, 3.0)), (_sigmoid, (-1.0, 1.0)), (np.sin, (-2.0, 5.0))):
        pj, pt = jmin.remez(f, [iv], 9), tmin.remez(f, [iv], 9)
        _equal(tmin.rebase_to_unit(pt), jmin.rebase_to_unit(pj))


@pytest.mark.parametrize("alpha,degrees", GOOD_SCHEDULES)
def test_composite_sign_equal(alpha, degrees):
    got = tmin.gen_minimax_composite_sign(alpha, degrees)
    want = jmin.gen_minimax_composite_sign(alpha, degrees)
    assert len(got) == len(want) == len(degrees)
    for g, w in zip(got, want):
        _equal(g, w)


def test_default_composite_and_step_fold_equal():
    got = tcmp.default_composite_sign_polys(5, (15, 15), 2)
    want = jcmp.default_composite_sign_polys(5, (15, 15), 2)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _equal(g, w)
    _equal(got[-1], tmm.SIGN_X4_CHEBY)
    _equal(tmm.SIGN_X2_CHEBY, jmm.SIGN_X2_CHEBY)
    _equal(tmm.SIGN_X4_CHEBY, jmm.SIGN_X4_CHEBY)

    # the composite step() evaluates: (x+1)/2 folded into the last stage
    def stages(module, polys):
        seen = []

        class Capture:
            def evaluate(self, ct, mcp):
                seen.extend(mcp)
                return ct

        ce = module.ComparisonEvaluator.__new__(module.ComparisonEvaluator)
        ce.sign_polys, ce.minimax = list(polys), Capture()
        ce.step(None)
        return seen

    for g, w in zip(stages(tcmp, got), stages(jcmp, want)):
        _equal(g, w)
    assert stages(tcmp, got)[-1].coeffs[0] == 0.5


@pytest.mark.parametrize("alpha,degrees", BAND_SCHEDULES)
def test_band_error_pinned(alpha, degrees):
    """Stage 1 cannot contract the band: the same ValueError in both."""
    with pytest.raises(ValueError) as want:
        jmin.gen_minimax_composite_sign(alpha, degrees)
    with pytest.raises(ValueError) as got:
        tmin.gen_minimax_composite_sign(alpha, degrees)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("composite stage 1 ")


def test_default_schedule_raises_in_both():
    with pytest.raises(ValueError, match="cannot contract the band"):
        jcmp.default_composite_sign_polys()
    with pytest.raises(ValueError, match="cannot contract the band"):
        tcmp.default_composite_sign_polys()


@pytest.mark.parametrize("alpha,degrees", CRASH_SCHEDULES)
def test_divergent_first_stage_pinned(alpha, degrees):
    """Stage 0 (degree 63) diverges and stage 1's Remez finds no solution:
    the JAX package crashes with a TypeError, the port names the stage."""
    with pytest.raises(TypeError, match="'NoneType' object is not iterable"):
        jmin.gen_minimax_composite_sign(alpha, degrees)
    with pytest.raises(ValueError, match=r"^composite stage 1 \(degree "
                       + str(degrees[1]) + r"\) on .*Remez found no solution.*"
                       r"stage 0 left the band"):
        tmin.gen_minimax_composite_sign(alpha, degrees)
