"""Pearson correlation of the PyTorch port vs the JAX package.

float32 on both sides with sums in another order: rtol 1e-5 /
atol 1e-6. The zero-power guard (telluride_decoding_tpu/ops/pearson.py:45)
must zero the whole result exactly."""

import numpy as np
import pytest
import torch

from telluride_decoding_tpu.ops import pearson as jax_pearson
from telluride_decoding_torch.ops import pearson


@pytest.mark.parametrize('shape', [(500,), (500, 1), (500, 4)])
def test_matches_jax(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    y = (0.6 * x + rng.randn(*shape)).astype(np.float32)
    got = pearson.pearson_correlation(torch.from_numpy(x),
                                      torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_pearson.pearson_correlation(x,
                                                                          y)),
                               rtol=1e-5, atol=1e-6)
    first = pearson.pearson_correlation_first(torch.from_numpy(x),
                                              torch.from_numpy(y))
    assert float(first) == pytest.approx(
        float(jax_pearson.pearson_correlation_first(x, y)), rel=1e-5)


def test_zero_power_guard_zeroes_everything(rng):
    x = rng.randn(100, 3).astype(np.float32)
    x[:, 1] = 2.0                                   # One flat column.
    y = rng.randn(100, 3).astype(np.float32)
    got = pearson.pearson_correlation(torch.from_numpy(x),
                                      torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, np.zeros(3, np.float32))
    np.testing.assert_array_equal(
        got, np.asarray(jax_pearson.pearson_correlation(x, y)))


def test_width_mismatch_raises():
    with pytest.raises(ValueError):
        pearson.pearson_correlation(torch.zeros(5, 2), torch.zeros(5, 3))


@pytest.mark.parametrize('name', ['pearson_correlation_second',
                                  'pearson_loss', 'correlation_matrix'])
def test_second_loss_and_matrix_match_jax(rng, name):
    """The three later functions, within 1e-5 (float32 sums in another
    order); correlation_matrix runs in full float32 on both sides."""
    x = rng.randn(400, 3).astype(np.float32)
    y = (0.5 * x + rng.randn(400, 3)).astype(np.float32)
    got = getattr(pearson, name)(torch.from_numpy(x), torch.from_numpy(y))
    want = np.asarray(getattr(jax_pearson, name)(x, y))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_second_and_loss_reject_bad_shapes():
    with pytest.raises(ValueError):
        pearson.pearson_correlation_second(torch.zeros(5), torch.zeros(5))
    with pytest.raises(ValueError):
        pearson.pearson_loss(torch.zeros(5, 2), torch.zeros(5, 3))
