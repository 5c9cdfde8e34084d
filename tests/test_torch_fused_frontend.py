"""Audio envelope + lag stack (K3) of the PyTorch port vs the JAX package.

On the CPU the port's wrapper takes its plain version; the JAX side runs
its Pallas kernel in interpret mode, as tests/test_fused_frontend.py
does, and its XLA reference. Tolerance: atol 1e-4, the JAX suite's own
bound for the kernel against its reference (float32 window sums in
another order, then a square root and a power).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from telluride_decoding_tpu.ops import fused_frontend as jax_ff
from telluride_decoding_torch.ops import fused_frontend

TOL = dict(atol=1e-4, rtol=0)
LOG2 = float(np.log10(2))


@pytest.mark.parametrize('case', [
    # tests/test_fused_frontend.py: 16 kHz -> 100 Hz, window 2, log10 2.
    dict(n=32000, fs_in=16000, fs_out=100, window=2.0, exponent=LOG2,
         pre=0, post=0),
    dict(n=32000, fs_in=16000, fs_out=100, window=2.0, exponent=LOG2,
         pre=3, post=2),
    dict(n=32000, fs_in=16000, fs_out=100, window=2.0, exponent=LOG2,
         pre=4, post=4),
    dict(n=1000, fs_in=200, fs_out=100, window=2.0, exponent=1.0,
         pre=1, post=1),                                    # 200 -> 100 Hz.
    dict(n=64000, fs_in=16000, fs_out=100, window=2.0, exponent=1.0,
         pre=2, post=2),                                    # Several tiles.
    dict(n=3 * 44100, fs_in=44100, fs_out=32, window=1.0, exponent=1.0,
         pre=0, post=0),                                    # Ingest rates.
], ids=['16k_00', '16k_32', '16k_44', '200Hz', 'tiles', '44k1_32Hz'])
def test_matches_jax_kernel_and_reference(rng, case):
    case = dict(case)
    n, fs_in, fs_out = case.pop('n'), case.pop('fs_in'), case.pop('fs_out')
    audio = rng.randn(n).astype(np.float32)
    got = fused_frontend.fused_envelope_lagstack(
        torch.from_numpy(audio), fs_in, fs_out, **case).numpy()
    kernel = np.asarray(jax_ff.fused_envelope_lagstack(
        audio, float(fs_in), float(fs_out), interpret=True, **case))
    reference = np.asarray(jax_ff.fused_envelope_lagstack_reference(
        audio, fs_in, fs_out, **case))
    assert got.shape == reference.shape == kernel.shape
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(got, reference, **TOL)


def test_constant_signal_envelope():
    audio = np.full(16000, 2.0, np.float32)
    got = fused_frontend.fused_envelope_lagstack(
        torch.from_numpy(audio), 16000, 100, window=1.0).numpy()
    want = np.asarray(jax_ff.fused_envelope_lagstack(
        audio, 16000., 100., window=1.0, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[5:-5, 0], 2.0, **TOL)


def test_valid_len_rows_past_the_end(rng):
    """Bucketed call: the windows clamp at the true end and rows past
    valid_out carry only lag-shifted valid frames in their pre columns
    (tests/test_fused_frontend.py:83-106)."""
    n = 30000
    audio = rng.randn(n).astype(np.float32)
    padded = np.zeros((1 << 16,), np.float32)
    padded[:n] = audio
    num_out = int(round(n / 16000 * 100))
    args = dict(window=2.0, pre=2, post=1)
    got = fused_frontend.fused_envelope_lagstack(
        torch.from_numpy(padded), 16000, 100, valid_len=n,
        valid_out=num_out, **args).numpy()
    want = np.asarray(jax_ff.fused_envelope_lagstack(
        padded, 16000., 100., interpret=True, valid_len=jnp.int32(n),
        valid_out=jnp.int32(num_out), **args))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got[:num_out],
        np.asarray(jax_ff.fused_envelope_lagstack_reference(
            audio, 16000, 100, **args)), **TOL)
    np.testing.assert_array_equal(got[num_out:, 2:], 0)
    np.testing.assert_array_equal(got[num_out + 2:], 0)


def test_window_bounds_are_the_host_float64_bounds():
    """44.1 kHz -> 32 Hz: the bounds are numpy's round-half-to-even of
    the float64 window edges, clamped to [0, N] (or valid_len)."""
    n, fs_in, fs_out = 44100 * 60, 44100.0, 32.0
    t1, t2 = fused_frontend.window_bounds(n, fs_in, fs_out, 1.0)
    m = np.arange(1920, dtype=np.float64)
    np.testing.assert_array_equal(
        t1, np.maximum(0, np.round(fs_in * (m / fs_out - 0.5 / fs_out))))
    np.testing.assert_array_equal(
        t2, np.minimum(n, np.round(fs_in * (m / fs_out + 0.5 / fs_out))))
    assert t1.dtype == t2.dtype == np.int32
    _, t2_cut = fused_frontend.window_bounds(n, fs_in, fs_out, 1.0,
                                             valid_len=n - 5000)
    assert t2_cut.max() == n - 5000


def test_rejects_bad_arguments():
    audio = torch.zeros(1000)
    with pytest.raises(ValueError):
        fused_frontend.fused_envelope_lagstack(audio, 1000, 100, window=0)
    with pytest.raises(ValueError):
        fused_frontend.fused_envelope_lagstack(audio, 1000, 100, pre=-1)
    with pytest.raises(ValueError):
        fused_frontend.fused_envelope_lagstack(audio, 1000, 100,
                                               valid_len=1001)
    with pytest.raises(ValueError):
        fused_frontend.fused_envelope_lagstack(audio, 1000, 100,
                                               valid_out=101)


def test_cpu_tensor_never_launches(rng):
    before = fused_frontend.fused_envelope_lagstack.launches
    fused_frontend.fused_envelope_lagstack(
        torch.from_numpy(rng.randn(8000).astype(np.float32)), 8000, 100)
    assert fused_frontend.fused_envelope_lagstack.launches == before
