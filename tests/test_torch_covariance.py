"""Moments of the PyTorch port vs the JAX package.

Tolerance: each matrix within 1e-5 of its own largest magnitude. Both
sides sum float32 products at full precision (JAX: Precision.HIGHEST;
torch: no TF32), only in another order, which costs about 1e-6 relative
to the largest entry at these sizes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from telluride_decoding_tpu.data import brain_data as jax_brain_data
from telluride_decoding_tpu.ops import covariance as jax_covariance
from telluride_decoding_torch.data.brain_data import device_file_moments
from telluride_decoding_torch.ops import covariance


def assert_moments_close(got, want, rel=1e-5):
    for name, g, w in zip(got._fields, got, want):
        g = g.numpy()
        w = np.asarray(w)
        bound = rel * max(float(np.max(np.abs(w))), 1e-30)
        assert g.shape == w.shape, name
        assert float(np.max(np.abs(g - w))) <= bound, name


def _data(rng, n=2000, dx=12, dy=3):
    x = rng.randn(n, dx).astype(np.float32) + 0.5
    y = (x[:, :dy] * 0.7 + rng.randn(n, dy)).astype(np.float32)
    return x, y


@pytest.mark.parametrize('want_syy', [False, True])
def test_moments_from_arrays_match_jax(rng, want_syy):
    x, y = _data(rng)
    got = covariance.moments_from_arrays(torch.from_numpy(x),
                                         torch.from_numpy(y),
                                         want_syy=want_syy)
    want = jax_covariance.moments_from_arrays(x, y, want_syy=want_syy)
    assert_moments_close(got, want)


def test_blocked_moments_with_ragged_valid_match_jax(rng):
    x, y = _data(rng, n=1999)
    valid = (np.arange(1999) < 1500).astype(np.float32)
    got = covariance.blocked_moments(torch.from_numpy(x), torch.from_numpy(y),
                                     block=256, want_syy=True,
                                     valid=torch.from_numpy(valid))
    want = jax_covariance.blocked_moments(x, y, block=256, want_syy=True,
                                          valid=jnp.asarray(valid))
    assert float(got.count) == 1500.0
    assert_moments_close(got, want)


def test_moments_add():
    a = covariance.zeros_moments(2, 1, 'cpu')
    b = a._replace(count=torch.tensor(3.0), sum_x=torch.ones(2))
    total = a + b
    assert float(total.count) == 3.0
    assert total.mean_x.tolist() == pytest.approx([1 / 3, 1 / 3])


@pytest.mark.parametrize('pre,post,pre_y,post_y', [(0, 4, 2, 2), (3, 0, 0, 0)])
def test_device_file_moments_match_jax(rng, pre, post, pre_y, post_y):
    """A buffer padded past the stream end with n_true < rows, as the
    JAX package's streaming fit feeds it."""
    n_true, rows = 900, 1024
    x = np.zeros((rows, 6), np.float32)
    y = np.zeros((rows, 1), np.float32)
    x[:n_true + post] = rng.randn(n_true + post, 6)
    y[:n_true + post_y] = rng.randn(n_true + post_y, 1)
    got = device_file_moments(torch.from_numpy(x), torch.from_numpy(y),
                              n_true, pre=pre, post=post, pre_y=pre_y,
                              post_y=post_y, want_syy=True)
    want = jax_brain_data._device_file_moments(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(n_true, jnp.float32),
        pre=pre, post=post, pre_y=pre_y, post_y=post_y, want_syy=True)
    assert_moments_close(got, want)
