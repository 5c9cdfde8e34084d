"""Ingest of the PyTorch port vs the JAX package: raw recordings in a
local cache -> TFRecords.

The caches are built from a seed in the shapes of
tests/test_mock_downloads.py (KULeuven: S<n>.mat subjects + stimuli/
wavs; Jens memory: one .mat per subject), written straight to a cache
directory: no archive, no download. The JAX side runs its ingest_data
on the CPU, where it takes its float64 cumsum envelope; the port runs
regression_data.main with --device cpu, which takes the same path. The
files must be the same set, and every field agrees within 1e-5 (the
z-scored features are float32).
"""

import os

import numpy as np
import pytest
import scipy.io as spio
import scipy.io.wavfile
import torch

from telluride_decoding_tpu.cli import regression_data as jax_rd
from telluride_decoding_tpu.data import records as jax_records
from telluride_decoding_tpu.io import ingest as jax_ingest
from telluride_decoding_torch.cli import regression_data
from telluride_decoding_torch.data import records
from telluride_decoding_torch.io import ingest
from telluride_decoding_torch.ops.fused_frontend import (
    fused_envelope_lagstack)

FIELD_TOL = 1e-5


def kuleuven_cache(rng, cache, subjects=16, trials=2, seconds=2,
                   sound_fs=8000):
    """S1..S<subjects>.mat + stimuli/part1_track{1,2}.wav."""
    os.makedirs(os.path.join(cache, 'stimuli'), exist_ok=True)
    names = ['part1_track1', 'part1_track2']
    for name in names:
        wav = (3000 * rng.randn(seconds * sound_fs)).astype(np.int16)
        scipy.io.wavfile.write(
            os.path.join(cache, 'stimuli', name + '.wav'), sound_fs, wav)
    for sid in range(subjects):
        mat_trials = np.empty((trials,), object)
        for t in range(trials):
            mat_trials[t] = {
                'attended_ear': 'L' if t % 2 == 0 else 'R',
                'stimuli': np.array(names, dtype=object),
                'RawData': {'EegData': rng.randn(128 * seconds, 8)},
                'FileHeader': {'SampleRate': 128.0},
            }
        spio.savemat(os.path.join(cache, 'S%d.mat' % (sid + 1)),
                     {'preproc_trials': mat_trials})


def jens_cache(rng, cache, subjects=2, trials=3):
    os.makedirs(cache, exist_ok=True)
    for sid in range(subjects):
        mat_trials = np.empty((trials,), object)
        for t in range(trials):
            mat_trials[t] = rng.randn(70, 256)
        spio.savemat(os.path.join(cache, 'subject_%02d.mat' % sid),
                     {'data': {'fsample': 128.0, 'trial': mat_trials}})


def tfrecord_files(tf_dir):
    return sorted(os.path.relpath(os.path.join(root, f), tf_dir)
                  for root, _, files in os.walk(tf_dir)
                  for f in files if f.endswith('.tfrecords'))


def assert_same_files(port_dir, jax_dir, tol=FIELD_TOL):
    files = tfrecord_files(port_dir)
    assert files and files == tfrecord_files(jax_dir)
    for name in files:
        got = records.read_tfrecords(os.path.join(port_dir, name))
        want = jax_records.read_tfrecords(os.path.join(jax_dir, name))
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0)
    return files


def port_main(type_, cache, tf_dir, rate, *more):
    return regression_data.main(['--type', type_, '--cache_dir', cache,
                                 '--tf_output_dir', tf_dir,
                                 '--desired_frame_rate', str(rate),
                                 '--device', 'cpu', *more])


def test_kuleuven_ingest_matches_jax(rng, tmp_path):
    cache = str(tmp_path / 'cache')
    kuleuven_cache(rng, cache)
    jax_rd.RegressionDataKULeuven().ingest_data(cache, str(tmp_path / 'jax'),
                                                32)
    launches = fused_envelope_lagstack.launches
    assert port_main('kuleuven', cache, str(tmp_path / 'port'), 32) == 0
    assert fused_envelope_lagstack.launches == launches   # CPU: cumsum.
    files = assert_same_files(str(tmp_path / 'port'), str(tmp_path / 'jax'))
    assert len(files) == 32 and 'S1/S1_T0.tfrecords' in files
    data = records.read_tfrecords(str(tmp_path / 'port' / 'S1' /
                                      'S1_T0.tfrecords'))
    assert set(data) == {'eeg', 'intensity', 'intensity2',
                         'attended_speaker'}
    assert data['eeg'].shape == (64, 8) and data['intensity'].shape == (64, 1)
    assert os.path.exists(str(tmp_path / 'port' / 'README.txt'))


def test_kuleuven_ingests_the_subjects_present(rng, tmp_path):
    cache = str(tmp_path / 'cache')
    kuleuven_cache(rng, cache, subjects=1, trials=3)
    assert port_main('kuleuven', cache, str(tmp_path / 'tf'), 32) == 0
    files = tfrecord_files(str(tmp_path / 'tf'))
    assert files == [
        'S1/S1_T0.tfrecords', 'S1/S1_T1.tfrecords', 'S1/S1_T2.tfrecords']
    # A rerun skips the trials on disk, a subject with none left too.
    first = os.path.getmtime(str(tmp_path / 'tf' / files[0]))
    assert port_main('kuleuven', cache, str(tmp_path / 'tf'), 32) == 0
    assert tfrecord_files(str(tmp_path / 'tf')) == files
    assert os.path.getmtime(str(tmp_path / 'tf' / files[0])) == first


def test_jens_memory_ingest_matches_jax(rng, tmp_path):
    cache = str(tmp_path / 'cache')
    jens_cache(rng, cache)
    jax_rd.RegressionDataJensMemory().ingest_data(cache, str(tmp_path / 'jax'),
                                                  64)
    assert port_main('jens_memory', cache, str(tmp_path / 'port'), 64) == 0
    files = assert_same_files(str(tmp_path / 'port'), str(tmp_path / 'jax'))
    assert len(files) == 6
    data = records.read_tfrecords(str(tmp_path / 'port' / 'subject_01' /
                                      'trial_01.tfrecords'))
    assert data['eeg'].shape == (128, 69)      # 256 @ 128 Hz -> 64 Hz.


def test_missing_cache_exits_nonzero(tmp_path):
    assert port_main('kuleuven', str(tmp_path / 'none'),
                     str(tmp_path / 'tf'), 32) == 1
    assert not os.path.exists(str(tmp_path / 'tf'))


def test_cuda_default_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError):
        regression_data.main(['--type', 'kuleuven', '--cache_dir',
                              str(tmp_path), '--tf_output_dir',
                              str(tmp_path / 'tf')])


def _experiment(module, rng_seed):
    rng = np.random.RandomState(rng_seed)
    trials = {}
    for t in range(3):
        n = 200 + 10 * t
        trials['trial_%d' % t] = [
            {'intensity': np.abs(rng.randn(n, 1)),
             'ones': np.ones((n, 1), np.float32)},
            module.MemoryBrainDataFile({'eeg_data': rng.randn(n + 5, 4),
                                        'other': rng.randn(n + 5, 2)},
                                       sr=64)]
    return module.BrainExperiment(trials, '.', '.', frame_rate=64)


def test_brain_experiment_zscore_and_write_byte_identical(tmp_path):
    outputs = {}
    for name, module in (('port', ingest), ('jax', jax_ingest)):
        exp = _experiment(module, 5)
        exp.load_all_data()
        exp.z_score_all_data()
        for trial in exp.iterate_trials():
            trial.assemble_brain_data('eeg_data, other')
        outputs[name] = exp.write_all_data(str(tmp_path / name))
        assert 'Found 3 trials' in exp.summary()
    assert [os.path.basename(p) for p in outputs['port']] == \
        [os.path.basename(p) for p in outputs['jax']]
    for port_path, jax_path in zip(outputs['port'], outputs['jax']):
        with open(port_path, 'rb') as f, open(jax_path, 'rb') as g:
            assert f.read() == g.read()
    data = records.read_tfrecords(outputs['port'][0])
    assert data['eeg'].shape == (200, 6)
    np.testing.assert_array_equal(data['ones'], 1.0)   # 'ones' not scored.


def test_find_mean_std_and_normalize_match_jax(rng):
    data = [rng.randn(50, 3) * 2 + 1, rng.randn(70, 3)]
    for columnwise in (False, True):
        got = ingest.find_mean_std(data, columnwise=columnwise)
        want = jax_ingest.find_mean_std(data, columnwise=columnwise)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(
            ingest.normalize_data(data[0], *got),
            jax_ingest.normalize_data(data[0], *want))


def test_load_sound_scales_int16(tmp_path, rng):
    wav = (3000 * rng.randn(800)).astype(np.int16)
    scipy.io.wavfile.write(str(tmp_path / 'x.wav'), 8000, wav)
    trial = ingest.BrainTrial('x.wav')
    trial.load_sound('x', sound_dir=str(tmp_path))
    assert trial.trial_name == 'x' and trial.sound_fs == 8000
    np.testing.assert_array_equal(trial.sound_data[:, 0],
                                  wav.astype(np.float32) / 32767.0)
    with pytest.raises(ValueError):
        trial.load_sound('missing', sound_dir=str(tmp_path))


def test_transform_tfrecords_matches_jax(rng, tmp_path):
    path = str(tmp_path / 'in.tfrecords')
    records.convert_data_to_tfrecords({'x': rng.randn(40, 2).astype(
        np.float32)}, path)

    def double(data):
        return 'y', 2 * data['x']
    got = ingest.transform_tfrecords(path, str(tmp_path / 'port'), 't',
                                     [double])
    want = jax_ingest.transform_tfrecords(path, str(tmp_path / 'jax'), 't',
                                          [double])
    with open(got, 'rb') as f, open(want, 'rb') as g:
        assert f.read() == g.read()


def test_jax_kuleuven_reingest_of_a_complete_subject_raises(rng, tmp_path):
    """The JAX side of the re-ingest fault the port does not copy: on a
    cache whose trials are all on disk, the JAX driver builds an empty
    BrainExperiment and z-scores it, and next(iter({}.values()))
    (telluride_decoding_tpu/io/ingest.py:603, reached from
    telluride_decoding_tpu/cli/regression_data.py:594-597) raises
    StopIteration. The port skips the subject instead
    (test_kuleuven_ingests_the_subjects_present)."""
    cache = str(tmp_path / 'cache')
    kuleuven_cache(rng, cache)            # The JAX driver reads S1..S16.
    tf_dir = str(tmp_path / 'jax')
    jax_rd.RegressionDataKULeuven().ingest_data(cache, tf_dir, 32)
    assert len(tfrecord_files(tf_dir)) == 32
    with pytest.raises(StopIteration):
        jax_rd.RegressionDataKULeuven().ingest_data(cache, tf_dir, 32)
