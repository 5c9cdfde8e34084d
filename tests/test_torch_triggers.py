"""Trigger alignment of the PyTorch port vs the JAX package.

The estimators (Theil-Sen regression and the mode histogram),
remove_close_times and BrainTrial's three trigger finders take the same
seeded inputs on both sides and must give exactly the same answers.
The EEG trigger channel inverts the Natus level fix as
tests/test_ingest.py:282-291 does.
"""

import numpy as np
import pytest

from telluride_decoding_tpu.io import ingest as jax_ingest
from telluride_decoding_torch.io import ingest

MODULES = [ingest, jax_ingest]


def both(name, *args, **kwargs):
    """(port result, JAX result) of the function ``name``."""
    return tuple(getattr(m, name)(*args, **kwargs) for m in MODULES)


@pytest.mark.parametrize('outlier', [0.0, 5.0])
def test_linear_regression_offset_matches_jax(rng, outlier):
    audio = np.sort(rng.rand(30) * 100)
    eeg = audio + 2.0 + 1e-3 * rng.randn(30)
    eeg[3] += outlier
    got, want = both('find_temporal_offset_via_linear_regression', audio,
                     eeg)
    assert got == want
    assert got[0] == pytest.approx(2.0, abs=0.05)
    assert got[1] == (1 if outlier else 0)


def test_linear_regression_uses_the_common_prefix(rng):
    audio = np.sort(rng.rand(12) * 60)
    eeg = np.concatenate([audio + 0.75, [99.0, 120.0]])
    got, want = both('find_temporal_offset_via_linear_regression', audio,
                     eeg)
    assert got == want and got[0] == pytest.approx(0.75)


@pytest.mark.parametrize('fs,max_time', [(1000.0, 0), (512.0, 4.0),
                                         (0, 0), (0, 300.0)])
def test_mode_histogram_matches_jax(rng, fs, max_time):
    audio = np.sort(rng.rand(15) * 50)
    eeg = audio + 1.25
    if not fs:               # Without fs the times are in samples.
        audio, eeg = np.round(audio * 100), np.round(eeg * 100)
    got, want = both('find_temporal_offset_via_mode_histogram', audio, eeg,
                     max_time=max_time, fs=fs)
    assert got == want and type(got) is type(want)
    assert got == pytest.approx(1.25 if fs else 125, abs=2e-3)


def test_mode_histogram_raises_without_pairs(rng):
    for module in MODULES:
        with pytest.raises(ValueError, match='No trigger-time pairs'):
            module.find_temporal_offset_via_mode_histogram(
                [1.0, 2.0], [10.0, 11.0], max_time=0.5, fs=100.0)


@pytest.mark.parametrize('times,min_time', [
    ([0.0, 0.01, 0.02, 1.0, 1.05, 2.0], 0.06),
    ([2.0, 0.0, 1.0, 1.03, 0.5], 0.06),
    ([0.0, 0.05, 0.1, 0.15, 0.2, 0.5], 0.06),
    ([3.0], 0.06),
    ([], 0.06),
])
def test_remove_close_times_matches_jax(times, min_time):
    got, want = both('remove_close_times', times, min_time=min_time)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def natus_raw(fixed):
    """The raw EDF level whose Natus fix is ``fixed`` (as
    tests/test_ingest.py:282-291 inverts it)."""
    return (fixed - 0.5 + 32768) / -0.0063606452364314 + 5151600


def trial_with(module, onsets, n=2000, sr=100.0, audio=None, cognionix=None):
    trial = module.BrainTrial('t')
    fixed = np.zeros(n)
    for s in onsets:
        fixed[s:s + 10] = 1.0
    trial._brain_data = {'TRIG': module.BrainSignal('TRIG',
                                                    natus_raw(fixed)[:, None],
                                                    sr)}
    if cognionix is not None:
        trial._brain_data['EXP32'] = module.BrainSignal('EXP32', cognionix,
                                                        sr)
    if audio is not None:
        trial.load_sound(audio, 16000)
    return trial


def test_find_eeg_trigger_times_matches_jax():
    onsets = [100, 500, 1200, 1201 + 30]
    got, want = (trial_with(m, onsets).find_eeg_trigger_times()
                 for m in MODULES)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # The finder reports the sample before the pulse's first sample.
    np.testing.assert_array_equal(got[0], (np.asarray(onsets) - 1) / 100.0)
    for module in MODULES:
        with pytest.raises(ValueError, match='channel name'):
            trial_with(module, onsets).find_eeg_trigger_times('NOPE')


def test_find_audio_trigger_times_matches_jax(rng):
    audio = np.zeros((16000, 2), np.float32)
    audio[:, 0] = rng.randn(16000)
    for start in (0, 1600, 8000, 8100):
        audio[start:start + 50, 1] = 1.0
    got, want = (trial_with(m, [10], audio=audio).find_audio_trigger_times()
                 for m in MODULES)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0.0, 0.1, 0.5, 0.50625])
    for module in MODULES:
        trial = trial_with(module, [10], audio=audio)
        with pytest.raises(ValueError, match='too high'):
            trial.find_audio_trigger_times(2)
        with pytest.raises(TypeError):
            module.BrainTrial('x').find_audio_trigger_times()


def test_find_cognionix_trigger_time_matches_jax():
    sig = np.zeros((1000, 1))
    sig[300:] = 9000.0
    for level, expected in ((8000, 3.0), (9500, None)):
        got, want = (trial_with(m, [10], cognionix=sig)
                     .find_cognionix_trigger_time(level=level)
                     for m in MODULES)
        assert got == want == expected
    for module in MODULES:
        with pytest.raises(ValueError, match='channel name'):
            trial_with(module, [10]).find_cognionix_trigger_time()


def test_fix_eeg_offset_trims_all_channels_like_jax():
    trials = []
    for module in MODULES:
        trial = module.BrainTrial('t')
        a = np.arange(500, dtype=np.float64)[:, None]
        trial._brain_data = {'C1': module.BrainSignal('C1', a.copy(), 100.0),
                             'C2': module.BrainSignal('C2', 2 * a, 100.0)}
        trial.fix_eeg_offset(1.005)
        trials.append(trial)
    for name in ('C1', 'C2'):
        np.testing.assert_array_equal(trials[0].brain_data[name].signal,
                                      trials[1].brain_data[name].signal)
    assert trials[0].brain_data['C1'].signal[0, 0] == 100.0
