"""Signal layer of the PyTorch port vs the JAX package and scipy.

Tolerances:
  * sosfilt: atol 1e-4 against scipy (float64) and against the JAX
    package, both float32 scans in another order. Where a pole sits
    near DC (0.5 Hz), the JAX scan itself drifts about 2e-4 from scipy
    over 2000 frames (tests/test_signal.py:34-37), so the port is held
    to 1e-4 against scipy and to the JAX suite's 1e-3 against JAX.
  * Preprocessor: atol 1e-4, the filters' bound, or the JAX suite's
    1e-3 where a highpass puts a pole near DC (the drift above);
    resampling, context and channel selection are copies.
  * compute_intensity on the CPU: both packages take the same float64
    cumsum path, atol 1e-6.
"""

import numpy as np
import pytest
import scipy.signal
import torch

from telluride_decoding_tpu.ops.lagstack import lag_stack_np as jax_lag_np
from telluride_decoding_tpu.signal import filters as jax_filters
from telluride_decoding_tpu.signal import preprocess as jax_pp
from telluride_decoding_tpu.signal.audio_stores import (
    AudioIntensityStore as JaxIntensityStore)
from telluride_decoding_torch.signal import filters, preprocess
from telluride_decoding_torch.signal.audio_stores import (AudioIntensityStore,
                                                          AudioLoudnessMick)


def _sosfilt(sos, x, zi=None):
    y, zf = filters.sosfilt(sos, torch.from_numpy(x), zi)
    return y.numpy(), zf.numpy()


@pytest.mark.parametrize('order,cutoff,btype,jax_tol', [
    (4, 2.0, 'hp', 1e-4), (2, 0.5, 'hp', 1e-3), (4, 30.0, 'lp', 1e-4),
    (10, 37.5, 'lp', 1e-4), (4, 5.0, 'hp', 1e-4)])
def test_sosfilt_matches_scipy_and_jax(rng, order, cutoff, btype, jax_tol):
    x = rng.randn(2000, 4).astype(np.float32)
    sos = filters.butter_sos(order, cutoff, btype, fs=100.0)
    np.testing.assert_array_equal(
        sos, jax_filters.butter_sos(order, cutoff, btype, fs=100.0))
    zi = np.zeros((sos.shape[0], 2, 4))
    want, want_state = scipy.signal.sosfilt(sos, x, axis=0, zi=zi)
    got, got_state = _sosfilt(sos, x)
    assert got.dtype == np.float32 and got_state.shape == want_state.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got_state, want_state, atol=1e-4)
    jax_y, jax_state = jax_filters.sosfilt(sos, x)
    np.testing.assert_allclose(got, np.asarray(jax_y), atol=jax_tol)
    np.testing.assert_allclose(got_state, np.asarray(jax_state),
                               atol=jax_tol)


def test_sosfilt_state_carries_across_batches(rng):
    """Two batches with the streaming start state equal one scipy pass
    (tests/test_signal.py:41-51), and each batch matches JAX's."""
    x = rng.randn(1500, 3).astype(np.float32) + 2.0
    sos = filters.butter_sos(4, 5.0, 'hp', fs=100.0)
    zi = filters.streaming_state_init(sos, torch.from_numpy(x[0]).double())
    jax_zi = jax_filters.streaming_state_init(sos, x[0])
    np.testing.assert_allclose(zi.numpy(), jax_zi, rtol=1e-6, atol=1e-7)
    want, _ = scipy.signal.sosfilt(sos, x, axis=0, zi=jax_zi)
    parts, state, jax_state = [], zi, jax_zi
    for chunk in np.array_split(x, 2):
        out, state = filters.sosfilt(sos, torch.from_numpy(chunk), state)
        jax_out, jax_state = jax_filters.sosfilt(sos, chunk,
                                                 np.asarray(jax_state))
        np.testing.assert_allclose(out.numpy(), np.asarray(jax_out),
                                   atol=1e-4)
        parts.append(out.numpy())
    np.testing.assert_allclose(np.concatenate(parts), want, atol=1e-4)


def test_sosfilt_1d_input(rng):
    x = rng.randn(500).astype(np.float32)
    sos = filters.butter_sos(2, 10.0, 'lp', fs=100.0)
    got, _ = _sosfilt(sos, x)
    want, _ = scipy.signal.sosfilt(sos, x[:, None], axis=0,
                                   zi=np.zeros((sos.shape[0], 2, 1)))
    np.testing.assert_allclose(got, want, atol=1e-4)


PREPROCESSORS = [
    dict(name='eeg', fs_in=100, fs_out=100, highpass_cutoff=1.0,
         highpass_order=2),
    dict(name='eeg', fs_in=1000, fs_out=100),              # Auto lowpass.
    dict(name='eeg', fs_in=200, fs_out=100, data_mean=0, data_std=1),
    dict(name='eeg', fs_in=100, fs_out=100, ref_channels=[[0], [3]],
         channels_to_ref=[[1], [2]]),
    dict(name='eeg', fs_in=100, fs_out=100, data_mean=None, data_std=None,
         pre_context=3, post_context=2),
    dict(name='eeg(highpass_cutoff=2;highpass_order=3;channel_numbers=0-1)',
         fs_in=100, fs_out=100),
    dict(name='eeg', fs_in=128, fs_out=64, highpass_cutoff=0.5,
         lowpass_cutoff=20, channel_numbers='1-3', pre_context=2),
]


@pytest.mark.parametrize('kwargs', PREPROCESSORS,
                         ids=['highpass', 'auto_lowpass', 'resample',
                              'reref', 'normalize_context', 'param_string',
                              'all_steps'])
def test_preprocessor_process_matches_jax(rng, kwargs):
    """All 7 steps over two streamed batches (filter, resampler and
    context state carried), then a reset."""
    tol = 1e-3 if ('highpass' in kwargs['name'] or
                   kwargs.get('highpass_cutoff')) else 1e-4
    port = preprocess.Preprocessor(device='cpu', **kwargs)
    ref = jax_pp.Preprocessor(**kwargs)
    assert (port.name, port.lowpass_cutoff, port.lowpass_order,
            port.highpass_cutoff, port.channel_numbers) == (
        ref.name, ref.lowpass_cutoff, ref.lowpass_order,
        ref.highpass_cutoff, ref.channel_numbers)
    x = (1.0 + rng.randn(1000, 4)).astype(np.float32)
    batches = [x] if kwargs['fs_in'] != kwargs['fs_out'] else \
        np.array_split(x, 2)
    for batch in batches:
        got, want = port.process(batch), ref.process(batch)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=tol)
    if kwargs['fs_in'] == kwargs['fs_out']:
        np.testing.assert_allclose(port.process(x, reset=True),
                                   ref.process(x, reset=True), atol=tol)


def test_preprocessor_rejects_bad_params():
    with pytest.raises(ValueError):
        preprocess.Preprocessor('x', fs_in=-1, fs_out=100, device='cpu')
    with pytest.raises(ValueError):
        preprocess.Preprocessor('x', fs_in=100, fs_out=100, pre_context=-1,
                                device='cpu')
    with pytest.raises(ValueError):
        preprocess.Preprocessor('x(highpass_cutof=2)', fs_in=100,
                                fs_out=100, device='cpu')


def test_streaming_context_matches_offline(rng):
    pre, post = 3, 2
    p = preprocess.Preprocessor('eeg', fs_in=100, fs_out=100,
                                pre_context=pre, post_context=post,
                                device='cpu')
    x = rng.randn(200, 2).astype(np.float32)
    streamed = np.concatenate([p.add_context(c)
                               for c in np.array_split(x, 4)])
    padded = np.concatenate([np.zeros((pre, 2), np.float32), x])
    offline = jax_lag_np(padded, pre, post)[pre:padded.shape[0] - post]
    np.testing.assert_array_equal(streamed, offline)


@pytest.mark.parametrize('fs_in,fs_out,window,exponent,channels', [
    (16000, 100, 2.0, float(np.log10(2)), 1),       # Single stream.
    (44100, 32, 1.0, 1.0, 1),                       # Ingest rates.
    (16000, 100, 2.0, 1.0, 2),                      # Multi-channel.
    (50, 100, 1.0, 1.0, 1),                         # Pass-through.
    (1000, 100, 5.0, 1.0, 1),                       # Wide window.
])
def test_compute_intensity_matches_jax(rng, fs_in, fs_out, window, exponent,
                                       channels):
    """Both packages on the CPU, a first call and a streaming second
    call that continues from the carried buffer."""
    port = preprocess.AudioFeatures('a', fs_in, fs_out, window=window,
                                    exponent=exponent, device='cpu')
    ref = jax_pp.AudioFeatures('a', fs_in, fs_out, window=window,
                               exponent=exponent)
    for n in (3 * fs_in // 2, fs_in // 2):
        audio = rng.randn(n, channels).astype(np.float32)
        got, want = port.compute_intensity(audio), ref.compute_intensity(audio)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6)
        if port._buff is None:
            assert ref._buff is None
        else:
            np.testing.assert_array_equal(port._buff, ref._buff)


def test_intensity_of_sine_and_constant():
    fs = 1000.0
    wave = np.sin(2 * np.pi * 50 * np.arange(10000) / fs).astype(np.float32)
    af = preprocess.AudioFeatures('audio', fs, 100.0, window=5, device='cpu')
    np.testing.assert_allclose(np.median(af.compute_intensity(wave[:, None])),
                               1 / np.sqrt(2), atol=0.02)
    af = preprocess.AudioFeatures('audio', fs, 100.0, window=1,
                                  exponent=np.log10(2), device='cpu')
    np.testing.assert_allclose(
        np.median(af.compute_intensity(np.full((5000, 1), 4.0, np.float32))),
        4.0 ** np.log10(2), atol=1e-3)


def test_spectrogram_matches_jax(rng):
    wave = rng.randn(8000).astype(np.float32)
    got, freqs = preprocess.AudioFeatures(
        'audio', 16000.0, 100.0, device='cpu').compute_spectrogram(wave)
    want, want_freqs = jax_pp.AudioFeatures(
        'audio', 16000.0, 100.0).compute_spectrogram(wave)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(freqs, want_freqs)


def test_audio_stores():
    store = AudioIntensityStore(window_step=4, window_width=4)
    store.add_data(2 * np.ones((8, 1)))
    jax_store = JaxIntensityStore(window_step=4, window_width=4)
    jax_store.add_data(2 * np.ones((8, 1)))
    assert list(store.next_window()) == list(jax_store.next_window()) == \
        [4.0, 4.0]
    loud = AudioLoudnessMick(window_step=4, window_width=4)
    loud.add_data(4 * np.ones((4, 1)))
    (value,) = list(loud.next_window())
    assert value == pytest.approx(4.0 ** np.log10(2))


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError):
        preprocess.AudioFeatures('a', 16000, 100)
    with pytest.raises(RuntimeError):
        preprocess.Preprocessor('eeg', 100, 100)
