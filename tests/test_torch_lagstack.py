"""Lag stack of the PyTorch port vs the JAX package (kernel K2's plain
version on the CPU; tests/test_torch_cuda.py checks the CUDA kernel on
the card).

A lag stack is a pure copy, so every comparison is bit-exact."""

import numpy as np
import pytest
import torch

from telluride_decoding_tpu.ops import lagstack as jax_lagstack
from telluride_decoding_torch.ops import lagstack

PAIRS = [(0, 0), (2, 0), (0, 3), (2, 3), (5, 5), (7, 1), (0, 36)]


def _signal(n=300, c=4, seed=0):
    return np.random.RandomState(seed).randn(n, c).astype(np.float32)


@pytest.mark.parametrize('pre,post', PAIRS)
def test_plain_matches_jax_reference(pre, post):
    x = _signal()
    got = lagstack.lag_stack(torch.from_numpy(x), pre, post).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_lagstack.lag_stack_reference(x, pre, post)))
    np.testing.assert_array_equal(got, jax_lagstack.lag_stack_np(x, pre,
                                                                 post))
    assert got.shape[1] == lagstack.stacked_width(4, pre, post)


@pytest.mark.parametrize('pre,post', PAIRS)
def test_host_copy_matches_jax(pre, post):
    x = _signal(n=37, c=3, seed=1)
    np.testing.assert_array_equal(lagstack.lag_stack_np(x, pre, post),
                                  jax_lagstack.lag_stack_np(x, pre, post))


@pytest.mark.parametrize('pre,post', [(2, 3), (0, 5), (37, 0)])
def test_plain_matches_pallas_kernel(pre, post):
    """Against the Pallas kernel in interpret mode, as
    tests/test_lagstack.py runs it on the CPU."""
    from jax.experimental.pallas import tpu as pltpu
    x = _signal(n=700, c=4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_lagstack.lag_stack(x, pre, post,
                                                 use_pallas=True))
    got = lagstack.lag_stack(torch.from_numpy(x), pre, post).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_rejects_other_devices_and_bad_context():
    x = torch.zeros((5, 2))
    with pytest.raises(ValueError):
        lagstack.lag_stack(x, -1, 2)
    with pytest.raises(ValueError):
        lagstack.lag_stack(x.to('meta'), 1, 2)
    assert lagstack.lag_stack.launches == 0   # CPU never launches.

