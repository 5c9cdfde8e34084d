"""Fused CCA decode of the PyTorch port vs the JAX package (kernel K1's
plain version on the CPU; tests/test_torch_cuda.py checks the CUDA
kernel on the card).

Tolerances: float32 rtol 1e-4 / atol 1e-4, the bound the JAX suite uses
between its Pallas kernel and its reference (tests/test_decode_kernel.py),
because the sums are taken in another order. bf16 windows: rtol 2e-2 /
atol 2e-2 as there; both sides round the rotations to bf16 the same way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from telluride_decoding_tpu.ops import decode_kernel as jax_decode
from telluride_decoding_torch.ops import decode_kernel

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _params(rng, f1=256, f2=31, d=10):
    return {
        'mean1': rng.randn(1, f1), 'mean2': rng.randn(1, f2),
        'rot1': rng.randn(f1, d) * 0.02, 'rot2': rng.randn(f2, d) * 0.2,
        'corr_mean_x': rng.randn(d) * 0.1, 'corr_mean_y': rng.randn(d) * 0.1,
        'corr_power': 1.0 + rng.rand(d), 'lda_w': rng.randn(d, 2),
        'lda_slope': np.float32(1.3), 'lda_intercept': np.float32(-0.25)}


def _jax(params):
    return {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}


def _folded(params):
    return decode_kernel.fold_decode_params(
        {k: torch.as_tensor(np.asarray(v, np.float32))
         for k, v in params.items()})


def test_fold_matches_jax(rng):
    params = _params(rng)
    want = jax_decode.fold_decode_params(_jax(params))
    got = _folded(params)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


@pytest.mark.parametrize('w,t,f1,block', [(8, 50, 256, 8), (16, 100, 384, 4),
                                          (16, 1, 128, 8)])
def test_f32_matches_jax_kernel_and_reference(rng, w, t, f1, block):
    params = _params(rng, f1=f1)
    x1 = rng.randn(w, t, f1).astype(np.float32)
    x2 = rng.randn(w, t, 31).astype(np.float32)
    got = decode_kernel.fused_cca_decode(
        _folded(params), torch.from_numpy(x1), torch.from_numpy(x2)).numpy()
    kernel = jax_decode.fused_cca_decode(_jax(params), jnp.asarray(x1),
                                         jnp.asarray(x2), window_block=block,
                                         interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), **F32_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_decode.fused_cca_decode_reference(
            _jax(params), jnp.asarray(x1), jnp.asarray(x2))), **F32_TOL)


def test_bfloat16_windows_match_jax_kernel(rng):
    params = _params(rng)
    x1 = jnp.asarray(rng.randn(8, 50, 256), jnp.float32).astype(jnp.bfloat16)
    x2 = jnp.asarray(rng.randn(8, 50, 31), jnp.float32).astype(jnp.bfloat16)
    want = jax_decode.fused_cca_decode(_jax(params), x1, x2, interpret=True)

    def to_torch(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    got = decode_kernel.fused_cca_decode(_folded(params), to_torch(x1),
                                         to_torch(x2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16_TOL)


def test_pair_form_matches_two_jax_decodes(rng):
    params = _params(rng)
    x1 = rng.randn(16, 1, 256).astype(np.float32)
    x2a = rng.randn(16, 1, 31).astype(np.float32)
    x2b = rng.randn(16, 1, 31).astype(np.float32)
    got = decode_kernel.fused_cca_decode(
        _folded(params), torch.from_numpy(x1), torch.from_numpy(x2a),
        torch.from_numpy(x2b)).numpy()
    assert got.shape == (2, 16)
    for row, x2 in zip(got, (x2a, x2b)):
        want = jax_decode.fused_cca_decode(_jax(params), jnp.asarray(x1),
                                           jnp.asarray(x2), interpret=True)
        np.testing.assert_allclose(row, np.asarray(want), **F32_TOL)


def test_wrapper_rejects_non_cuda_devices(rng):
    folded = decode_kernel.FoldedDecode(
        *(t.to('meta') for t in _folded(_params(rng))))
    x1 = torch.zeros((2, 1, 256), device='meta')
    x2 = torch.zeros((2, 1, 31), device='meta')
    with pytest.raises(ValueError):
        decode_kernel.fused_cca_decode(folded, x1, x2)
    assert decode_kernel.fused_cca_decode.launches == 0

