"""The trigger authoring tool of the PyTorch port vs the JAX package's
(tests/test_cli_tools.py:13-85 on both): the same draws for the same
RandomState, the same int16 stereo audio, and main writing the same wav
for the same input and generator."""

import functools

import numpy as np
import pytest
import scipy.io.wavfile
from absl.testing import flagsaver

from telluride_decoding_tpu.cli import add_trigger as jax_add_trigger
from telluride_decoding_torch.cli import add_trigger


@pytest.mark.parametrize('duration,number,interval,include_zero', [
    (60.0, 20, 0.5, True), (59.8, 60, 0.5, True), (10.0, 15, 0.5, False),
    (5.0, 1, 0.5, True), (5.0, 0, 0.5, True), (30.0, 6, 5.0, False)])
def test_random_times_same_draws(duration, number, interval, include_zero):
    got = add_trigger.random_times(duration, number, interval, include_zero,
                                   rng=np.random.RandomState(3))
    want = jax_add_trigger.random_times(duration, number, interval,
                                        include_zero,
                                        rng=np.random.RandomState(3))
    np.testing.assert_array_equal(got, want)
    assert len(got) == max(number, 0)
    if number > 1:
        assert np.min(np.diff(got)) >= interval
        assert got[-1] <= duration
    if include_zero and number:
        assert got[0] == 0.0


def test_random_times_impossible():
    for module in (add_trigger, jax_add_trigger):
        with pytest.raises(ValueError):
            module.random_times(1.0, 100, minimum_interval=0.5)


@pytest.mark.parametrize('pulse_freq,shape', [(0, (16000 * 5,)),
                                              (1000, (16000 * 5,)),
                                              (0, (16000 * 5, 2)),
                                              (250, (16000 * 5, 1))])
def test_add_events_same_int16(rng, pulse_freq, shape):
    audio = (1000 * rng.randn(*shape)).astype(np.int16)
    events = np.array([0.0, 1.0, 3.0, 4.2])
    got = add_trigger.add_events_to_audio(audio, events, fs=16000,
                                          pulse_length=0.05,
                                          pulse_freq=pulse_freq)
    want = jax_add_trigger.add_events_to_audio(audio, events, fs=16000,
                                               pulse_length=0.05,
                                               pulse_freq=pulse_freq)
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    assert got.shape == (16000 * 5, 2)
    if not pulse_freq:
        assert got[int(1.02 * 16000), 1] == 32767
        assert got[int(2.0 * 16000), 1] == 0


def test_add_events_validation():
    for module in (add_trigger, jax_add_trigger):
        with pytest.raises(TypeError):
            module.add_events_to_audio([1, 2, 3], [0.1, 0.2, 0.3])
        with pytest.raises(ValueError):
            module.add_events_to_audio(np.zeros(100, np.int16),
                                       [0.1, 0.2, 0.3], fs=100)
        with pytest.raises(ValueError):
            module.add_events_to_audio(np.zeros(100000, np.int16), [0.1],
                                       fs=16000)


def test_wav_roundtrip(rng, tmp_path):
    audio = (1000 * rng.randn(16000)).astype(np.int16)
    path = str(tmp_path / 'x.wav')
    add_trigger.write_audio_wave_file(path, audio, 16000)
    assert add_trigger.read_audio_wave_file(path)[0] == 16000
    fs, back = jax_add_trigger.read_audio_wave_file(path)
    assert fs == 16000
    np.testing.assert_array_equal(back, audio)
    for module in (add_trigger, jax_add_trigger):
        with pytest.raises(TypeError):
            module.write_audio_wave_file(path, [1, 2], 16000)
        with pytest.raises(TypeError):
            module.read_audio_wave_file(3)


@pytest.mark.parametrize('flags,values', [
    ([], {}),
    (['--number_of_events=-5'], dict(number_of_events=-5)),
    (['--number_of_events', '12'], dict(number_of_events=12)),
    (['--pulse_length', '0.05', '--pulse_freq', '440', '--verbose'],
     dict(pulse_length=0.05, pulse_freq=440.0, verbose=True))])
def test_main_writes_the_same_wav(rng, tmp_path, monkeypatch, flags,
                                  values):
    src = str(tmp_path / 'in.wav')
    scipy.io.wavfile.write(src, 16000,
                           (800 * rng.randn(16000 * 30)).astype(np.int16))
    port_out = str(tmp_path / 'port.wav')
    jax_out = str(tmp_path / 'jax.wav')
    assert add_trigger.main(['--input_filename', src, '--output_filename',
                             port_out] + flags,
                            rng=np.random.RandomState(11)) == 0
    # The JAX tool draws from a fresh RandomState; give it the same one.
    monkeypatch.setattr(jax_add_trigger, 'random_times', functools.partial(
        jax_add_trigger.random_times, rng=np.random.RandomState(11)))
    jax_add_trigger.FLAGS(['prog'])
    with flagsaver.flagsaver(**dict(
            dict(number_of_events=-1, pulse_length=0.1, pulse_freq=0.0,
                 verbose=False), input_filename=src,
            output_filename=jax_out, **values)):
        jax_add_trigger.main(['prog'])
    with open(port_out, 'rb') as f, open(jax_out, 'rb') as g:
        assert f.read() == g.read()


def test_main_rejects_bad_flags(tmp_path):
    with pytest.raises(SystemExit):
        add_trigger.main(['--output_filename', str(tmp_path / 'o.wav')])
    src = str(tmp_path / 'in.wav')
    scipy.io.wavfile.write(src, 16000, np.zeros(16000 * 4, np.int16))
    with pytest.raises(ValueError, match='Pulse length'):
        add_trigger.main(['--input_filename', src, '--output_filename',
                          str(tmp_path / 'o.wav'), '--pulse_length', '0'])
    with pytest.raises(ValueError, match='0 events'):
        add_trigger.main(['--input_filename', src, '--output_filename',
                          str(tmp_path / 'o.wav'), '--number_of_events',
                          '0'])
