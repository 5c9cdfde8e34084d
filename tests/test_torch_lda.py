"""Scaled LDA of the PyTorch port vs the JAX package.

Both fit the same float32 generalized eigenproblem (Cholesky whitening +
eigh). An eigenvector's sign is arbitrary, but the slope absorbs it, so
the first transform column (the one the decoder uses), the class-mean
mapping and the intercept must agree: rtol 1e-4 / atol 1e-5 (float32
factorizations by two LAPACK backends). The first projection column
agrees up to that sign. With two classes the between-class scatter has
rank one, so the other columns span a degenerate eigenspace that either
library may rotate: they are not compared."""

import numpy as np
import pytest

from telluride_decoding_tpu.solvers import lda as jax_lda
from telluride_decoding_torch.solvers import lda


def _two_classes(rng, n=600, d=3):
    x0 = rng.randn(n, d) + [0.0, 0.5, -0.2][:d]
    x1 = rng.randn(n, d) * 1.2 + [1.0, -0.5, 0.3][:d]
    x = np.concatenate([x0, x1]).astype(np.float32)
    y = np.concatenate([np.ones(n), 2 * np.ones(n)])
    return x, y


@pytest.mark.parametrize('d', [1, 3])
def test_scaled_lda_matches_jax(rng, d):
    x, y = _two_classes(rng, d=d)
    got = lda.ScaledLinearDiscriminantAnalysis('cpu')
    want = jax_lda.ScaledLinearDiscriminantAnalysis()
    got_out = got.fit_transform(x, y)
    want_out = want.fit_transform(x, y)
    np.testing.assert_allclose(got_out[:, 0], want_out[:, 0], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.intercept, want.intercept, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(abs(got.slope), abs(want.slope), rtol=1e-4)
    w_got, w_want = got.coef_array[:, 0], want.coef_array[:, 0]
    np.testing.assert_allclose(w_got * np.sign(w_got @ w_want), w_want,
                               rtol=1e-4, atol=1e-5)
    # Class means map to 0 and 1.
    np.testing.assert_allclose(
        got.transform(np.stack(got.mean_vectors))[:, 0], [0.0, 1.0],
        atol=1e-5)


def test_parameters_cross_load(rng):
    """A fit in either package restores in the other (the re/im JSON
    schema) and transforms identically."""
    x, y = _two_classes(rng)
    jax_fit = jax_lda.ScaledLinearDiscriminantAnalysis()
    jax_fit.fit(x, y)
    port = lda.ScaledLinearDiscriminantAnalysis('cpu')
    port.model_parameters = jax_fit.model_parameters
    np.testing.assert_allclose(port.transform(x), jax_fit.transform(x),
                               rtol=1e-6)
    back = jax_lda.ScaledLinearDiscriminantAnalysis()
    back.model_parameters = port.model_parameters
    np.testing.assert_allclose(back.transform(x), jax_fit.transform(x),
                               rtol=1e-6)


def test_fit_two_classes_and_errors(rng):
    port = lda.ScaledLinearDiscriminantAnalysis('cpu')
    port.fit_two_classes(rng.randn(50, 2), rng.randn(50, 2) + 2)
    assert port.explained_variance_ratio().shape == (2,)
    with pytest.raises(ValueError):
        port.fit_two_classes(rng.randn(5, 2), rng.randn(5, 3))
    with pytest.raises(ValueError):
        lda.ScaledLinearDiscriminantAnalysis('cpu').fit(
            rng.randn(9, 2), np.arange(9) % 3)
    with pytest.raises(ValueError):
        lda.LinearDiscriminantAnalysis('cpu').transform(rng.randn(3, 2))


@pytest.mark.parametrize('data', ['nan', 'zeros'])
def test_degenerate_classes_match_jax(data):
    """Correlations of a regressor whose output is constant: NaN (its
    power is 0) gives a NaN projection and NaN scores in both packages
    (the driver's d' is nan), exactly equal classes the same error."""
    fill = np.nan if data == 'nan' else 0.0
    x = np.full((20, 3), fill, np.float32)
    y = np.array([1] * 10 + [2] * 10)
    outcomes = []
    for model in (lda.ScaledLinearDiscriminantAnalysis('cpu'),
                  jax_lda.ScaledLinearDiscriminantAnalysis()):
        try:
            outcomes.append(('scores', np.isnan(
                model.fit_transform(x, y)).all(), np.isnan(model.slope)))
        except ValueError as error:
            outcomes.append(('error', str(error)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ('scores' if data == 'nan' else 'error')


@pytest.mark.parametrize('name', ['LinearDiscriminantAnalysis',
                                  'ScaledLinearDiscriminantAnalysis'])
def test_from_fitted_data_matches_jax(rng, name):
    """from_fitted_data of the plain and the scaled LDA, each a new
    object of its class fitted on one seeded two-class set: the same
    transform as JAX's (first column up to its sign for the plain LDA,
    whose projection has no slope to absorb it)."""
    x, y = _two_classes(rng, d=3)
    got = getattr(lda, name).from_fitted_data(x, y, device='cpu')
    want = getattr(jax_lda, name).from_fitted_data(x, y)
    assert type(got) is getattr(lda, name)
    assert list(got.labels) == list(want.labels)
    g, w = got.transform(x)[:, 0], np.asarray(want.transform(x))[:, 0]
    if name == 'LinearDiscriminantAnalysis':
        g = g * np.sign(np.dot(g, w))
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.mean_vectors),
                               np.asarray(want.mean_vectors), rtol=1e-4,
                               atol=1e-5)
