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



def _unpack_mma_b(packed):
    """[K / 16, 32, 8] fragments back to [K, 16]. mma.m16n8k16's B
    operand puts column g (tile 0) and 8 + g (tile 1) of the fragment's
    rows 2c, 2c + 1, 2c + 8, 2c + 9 in lane 4 g + c; the kernel feeds
    features 4c .. 4c + 3 of the k-step to those rows."""
    packed = packed.float().numpy()
    out = np.full((packed.shape[0] * 16, 16), np.nan, np.float32)
    for s in range(packed.shape[0]):
        for lane in range(32):
            g, c = divmod(lane, 4)
            for t in range(2):
                for i in range(4):
                    out[16 * s + 4 * c + i, 8 * t + g] = \
                        packed[s, lane, 4 * t + i]
    return out


@pytest.mark.parametrize('f,d', [(2553, 10), (1408, 5), (17, 16), (5, 1)])
def test_pack_mma_b_is_padded_bf16_rotation(rng, f, d):
    rot = torch.from_numpy((rng.randn(f, d) * 0.02).astype(np.float32))
    packed = decode_kernel.pack_mma_b(rot)
    k = -(-f // 16) * 16
    assert packed.dtype == torch.bfloat16
    assert tuple(packed.shape) == (k // 16, 32, 8)
    want = np.zeros((k, 16), np.float32)
    want[:f, :d] = rot.to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(_unpack_mma_b(packed), want)


def test_prepared_operands_are_kept_per_parameter_set(rng):
    folded = _folded(_params(rng))
    for dtype in (torch.bfloat16, torch.float32):
        first = decode_kernel.prepared_operands(folded, dtype)
        assert decode_kernel.prepared_operands(folded, dtype) is first
    bf16 = decode_kernel.prepared_operands(folded, torch.bfloat16)
    f32 = decode_kernel.prepared_operands(folded, torch.float32)
    assert bf16 is not f32
    # float32: rotations zero-padded to 16 columns (D = 10), constants c1,
    # c2, scale padded the same, then the intercept.
    for got, rot in ((f32.rot1, folded.rot1), (f32.rot2, folded.rot2)):
        assert tuple(got.shape) == (rot.shape[0], 16)
        torch.testing.assert_close(got[:, :10], rot, rtol=0, atol=0)
        assert not got[:, 10:].any()
    assert f32.consts.shape == (3 * 16 + 1,)
    torch.testing.assert_close(f32.consts[32:42], folded.scale, rtol=0,
                               atol=0)
    assert f32.pointers == tuple(t.data_ptr() for t in f32[:3])
    # bf16: both rotations as B fragments, constants padded to 16.
    for got, rot in ((bf16.rot1, folded.rot1), (bf16.rot2, folded.rot2)):
        torch.testing.assert_close(got, decode_kernel.pack_mma_b(rot),
                                   rtol=0, atol=0)
    assert bf16.consts.shape == (3 * 16 + 1,)
    assert not bf16.consts[26:32].any()
    torch.testing.assert_close(bf16.consts[16:26], folded.c2, rtol=0,
                               atol=0)
    assert float(bf16.consts[-1]) == float(folded.intercept)
    # A refit (new tensors) and an in-place edit both give new operands.
    refit = _folded(_params(rng))
    assert decode_kernel.prepared_operands(refit, torch.bfloat16) is not bf16
    folded.rot1.mul_(2.0)
    edited = decode_kernel.prepared_operands(folded, torch.bfloat16)
    assert edited is not bf16
    torch.testing.assert_close(
        edited.rot1, decode_kernel.pack_mma_b(folded.rot1), rtol=0, atol=0)


@pytest.mark.parametrize('f1,f2,windows,chunk,wpb', [
    (2553, 31, 512, 2560, 4),      # The flagship: one chunk, 128 blocks.
    (1408, 31, 228, 1408, 2),      # KULeuven width: 11 x 128.
    (17, 5, 1, 128, 1),
    (10000, 31, 7, 3072, 1),       # Wider than a chunk: 4 chunks.
    (2553, 500, 3, 2176, 1),       # Wide x2 rows narrow the chunk.
])
def test_mma_plan_fits_shared_memory(f1, f2, windows, chunk, wpb):
    got_chunk, got_wpb, smem = decode_kernel.mma_plan(f1, f2, windows, 132)
    assert (got_chunk, got_wpb) == (chunk, wpb)
    assert smem == decode_kernel.mma_smem_bytes(chunk, f2, wpb) <= 232448
    assert -(-windows // wpb) <= 132


def test_mma_plan_raises_when_x2_rows_cannot_fit():
    with pytest.raises(ValueError):
        decode_kernel.mma_plan(2553, 4000, 512, 132)


@pytest.mark.parametrize('n,f1,d', [(11, 2553, 10), (28, 2553, 10),
                                    (32, 2553, 10), (11, 1408, 5),
                                    (28, 1408, 5), (32, 1408, 5)])
def test_f32_serving_pair_matches_jax(rng, n, f1, d):
    """The serving call: a chunk of N frames as windows of T = 1, pair
    form, at codelab (2553, D 10) and KULeuven (1408, D 5) width, against
    the JAX reference and, where N is a multiple of its 8-row tiling, the
    JAX kernel in interpret mode."""
    params = _params(rng, f1=f1, d=d)
    x1 = rng.randn(n, 1, f1).astype(np.float32)
    x2a = rng.randn(n, 1, 31).astype(np.float32)
    x2b = rng.randn(n, 1, 31).astype(np.float32)
    got = decode_kernel.fused_cca_decode(
        _folded(params), *(torch.from_numpy(a) for a in (x1, x2a, x2b)))
    assert tuple(got.shape) == (2, n)
    for row, x2 in zip(got.numpy(), (x2a, x2b)):
        np.testing.assert_allclose(
            row, np.asarray(jax_decode.fused_cca_decode_reference(
                _jax(params), jnp.asarray(x1), jnp.asarray(x2))), **F32_TOL)
        if n % 8 == 0:
            np.testing.assert_allclose(
                row, np.asarray(jax_decode.fused_cca_decode(
                    _jax(params), jnp.asarray(x1), jnp.asarray(x2),
                    window_block=8, interpret=True)), **F32_TOL)


@pytest.mark.parametrize('windows,frames,f1,d', [
    (32, 1, 2553, 10), (32, 1, 1408, 5),      # A served chunk.
    (11, 1, 2553, 10), (28, 1, 1408, 5),      # Shorter chunks.
    (33, 1, 2553, 10),                        # Two tiles.
    (4096, 1, 2553, 10), (4096, 1, 1408, 5),  # Many tiles.
    (7, 13, 2553, 10), (64, 100, 2553, 10),   # Windows of many frames.
    (1, 1, 31, 1), (3, 1, 5, 16), (300, 13, 5000, 16),
])
def test_f32_plan_splits_features_over_a_cluster(windows, frames, f1, d):
    del d  # The kernel takes every D <= 16 in 16 columns.
    cluster, wpt, slice_, chunk, smem = decode_kernel.f32_plan(
        windows, frames, f1, 31, 132)
    assert cluster in (1, 2, 4, 8, 16)
    # Every feature falls in exactly one block's slice, staged in chunks.
    owners = np.zeros(f1, int)
    for k in range(cluster):
        owners[k * slice_:min((k + 1) * slice_, f1)] += 1
    assert (owners == 1).all()
    assert 1 <= chunk <= min(slice_, decode_kernel.F32_MAX_CHUNK)
    assert smem == decode_kernel.f32_smem_bytes(chunk, 31, cluster, wpt)
    assert smem <= 232448
    # A tile holds whole windows: up to 32 rows, or one longer window.
    assert wpt >= 1 and (wpt * frames <= 32 or wpt == 1)
    blocks = -(-windows // wpt) * cluster
    if windows * frames <= 32:
        assert wpt >= windows and cluster >= 8  # One tile on >= 8 blocks.
    if windows == 4096:
        assert blocks >= 132                     # A block on every SM.


def test_f32_plan_raises_when_x2_rows_cannot_fit():
    with pytest.raises(ValueError):
        decode_kernel.f32_plan(32, 1, 2553, 2000, 132)
