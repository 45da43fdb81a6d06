"""The port's polynomial evaluation against the JAX package's
phantom_tpu/schemes/poly.py.

The schedule helpers (bsgs_counts, poly_depth, chebyshev_fit, the
Chebyshev division) are numpy in both packages and are compared live;
poly_eval_fast32 (dense degree 7, sparse degree 9, odd degree 7) and
poly_eval_cheb_fast32 (degree 13 on [-1, 1], degree 11 with an interval)
are compared with the golden file tests/fixtures/torch_port/
poly_n1024.npz (n = 1024, nine 28-bit data primes, three special; JAX
keys, encryption and Fast32 outputs, the host encoder for the constants)
bit for bit with metadata.  The degenerate inputs raise as in the JAX
package (tests/test_poly.py:167-175)."""

import numpy as np
import pytest
import torch

import chip_smoke
from phantom_tpu.schemes import poly as jpoly
from phantom_tpu_torch.schemes import poly

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def results():
    return chip_smoke.poly_golden(CPU)


@pytest.mark.parametrize("case", list(chip_smoke.POLY_CASES))
def test_poly_eval_bit_match(results, case):
    got, want = results[f"poly: y_{case}"]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("degree", [1, 2, 3, 7, 13, 15, 23, 31, 64])
@pytest.mark.parametrize("bs", [None, 2, 3, 8])
def test_schedule_matches_jax(degree, bs):
    assert poly.bsgs_counts(degree, bs) == jpoly.bsgs_counts(degree, bs)
    assert poly.poly_depth(degree, bs) == jpoly.poly_depth(degree, bs)


@pytest.mark.parametrize("degree,interval", [(13, (-1.0, 1.0)),
                                             (15, (-8.0, 8.0)),
                                             (23, (-2.25, 2.25))])
def test_chebyshev_fit_matches_jax(degree, interval):
    f = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    np.testing.assert_array_equal(poly.chebyshev_fit(f, degree, interval),
                                  jpoly.chebyshev_fit(f, degree, interval))


@pytest.mark.parametrize("m", [2, 4, 8])
def test_chebyshev_split_matches_jax(m):
    c = list(np.random.default_rng(m).uniform(-1, 1, 2 * m))
    mine = poly._PolyEvaluator(None, None, m, "chebyshev")._split(c, m)
    ref = jpoly._PolyEvaluator(None, None, m, "chebyshev")._split(c, m)
    assert mine == ref


def test_degenerate_inputs():
    with pytest.raises(ValueError):
        poly.poly_eval_fast32(None, None, [1.0], None)          # constant
    with pytest.raises(ValueError):
        poly.poly_eval_fast32(None, None, [1.0, 0.0, 0.0], None)
    with pytest.raises(ValueError):
        poly.poly_eval_cheb_fast32(None, None, [0.5], None)
