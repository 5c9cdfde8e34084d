"""Ridge solver of the PyTorch port vs the JAX package.

The same seeded numpy data go through both packages' moment solve and
in-memory fit, for ridge, shrinkage, Ledoit-Wolf automatic shrinkage
(lamb == -1) and no offset. At this well-conditioned size (400 x 12) the
float32 systems agree to w and b within 1e-4 relative (of the largest
weight), and the shrinkage used within 1e-5.
"""

import numpy as np
import pytest
import torch

from telluride_decoding_tpu.ops import covariance as jax_cov
from telluride_decoding_tpu.solvers import ridge as jax_ridge
from telluride_decoding_torch.ops import covariance
from telluride_decoding_torch.solvers import ridge

REL = 1e-4
CASES = {
    'ridge': dict(lamb=0.1),
    'shrinkage': dict(lamb=0.3, use_ridge=False),
    'ledoit_wolf': dict(lamb=-1, use_ridge=False),
    'no_offset': dict(lamb=0.05, use_offset=False),
}


def _data(rng, n=400, dx=12, dy=2):
    x = (rng.randn(n, dx) + 0.3).astype(np.float32)
    w = rng.randn(dx, dy).astype(np.float32)
    y = (x @ w + 0.5 + 0.2 * rng.randn(n, dy)).astype(np.float32)
    return x, y


def _assert_solution_close(got, want):
    for name in ('w', 'b'):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=REL * np.max(np.abs(w)))
    assert float(got.shrinkage) == pytest.approx(float(want.shrinkage),
                                                 rel=1e-5, abs=1e-7)


@pytest.mark.parametrize('case', sorted(CASES))
def test_fit_matches_jax(rng, case):
    x, y = _data(rng)
    kwargs = CASES[case]
    got = ridge.calculate_linear_regressor_parameters(
        torch.from_numpy(x), torch.from_numpy(y), **kwargs)
    want = jax_ridge.calculate_linear_regressor_parameters(x, y, **kwargs)
    _assert_solution_close(got, want)
    if case == 'ledoit_wolf':
        assert 0.0 < float(got.shrinkage) < 1.0


@pytest.mark.parametrize('case', sorted(CASES))
def test_solve_from_moments_matches_jax(rng, case):
    x, y = _data(rng)
    kwargs = dict(CASES[case])
    kwargs.pop('lamb')
    # Without the centered squares, lamb == -1 clamps to no shrinkage.
    lamb = CASES[case]['lamb']
    got = ridge.solve_ridge_from_moments(
        covariance.moments_from_arrays(torch.from_numpy(x),
                                       torch.from_numpy(y)),
        lamb=lamb, **kwargs)
    want = jax_ridge.solve_ridge_from_moments(
        jax_cov.moments_from_arrays(x, y), lamb=lamb, **kwargs)
    _assert_solution_close(got, want)
    np.testing.assert_allclose(got.cov_x.numpy(), np.asarray(want.cov_x),
                               rtol=1e-5, atol=1e-5)


def test_shrinkage_out_of_range_raises(rng):
    x, y = _data(rng, n=50)
    with pytest.raises(ValueError):
        ridge.calculate_linear_regressor_parameters(
            torch.from_numpy(x), torch.from_numpy(y), lamb=1.5,
            use_ridge=False)
