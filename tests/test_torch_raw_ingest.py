"""The raw-recording ingest slice as a whole, the port vs the JAX
package, at small size: chip_smoke.py's phase 12 (a) on the CPU.

build_lab_recordings (tools/raw_recordings.py) writes a lab's own
recordings (stereo wavs through the port's cli.add_trigger.main, EDF of
EEG and a Natus TRIG channel with a planted lead, a BrainVision copy of
trial 1); lab_ingest runs them through either package's ingest API
(BrainExperiment with EdfBrainDataFile, both lead estimators,
fix_eeg_offset, the intensity envelope, the EEG resample, z-score,
TFRecords). The leads must be equal and the records within 1e-5 (the
JAX side takes its float64 cumsum envelope on the CPU, as the port
does there). Then the port's records go through cli.decoding.main.
"""

import contextlib
import io
import os

import numpy as np
import pytest

import chip_smoke
from telluride_decoding_tpu.data import records as jax_records
from telluride_decoding_tpu.io import ingest as jax_ingest
from telluride_decoding_tpu.signal import preprocess as jax_preprocess
from telluride_decoding_torch.cli import decoding
from telluride_decoding_torch.data import records
from telluride_decoding_torch.data.brain_data import TFExampleData
from telluride_decoding_torch.decode.infer_decoder import create_decoder
from telluride_decoding_torch.io import ingest
from telluride_decoding_torch.ops.fused_frontend import (
    fused_envelope_lagstack)
from telluride_decoding_torch.signal import preprocess
from tools import raw_recordings

RECORD_TOL = 1e-5
# Phase 12 (a) cut to size: 2 trials of 20 s, 4 EEG channels and TRIG
# at 512 Hz, stereo wavs at 44.1 kHz with an event every 5 s, leads of
# 0.25-2 s, and 64 Hz frames.
SMALL_LAB = dict(trials=2, seconds=20, channels=4, eeg_fs=512,
                 audio_fs=44100, event_every=5, lead_samples=(128, 1024))
RATE = 64
CONTEXTS = (0, 4, 2, 2)       # eeg pre, post; intensity pre, post.


@pytest.fixture(scope='module')
def lab(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('lab'))
    planted, names, onsets = raw_recordings.build_lab_recordings(
        root, **SMALL_LAB)
    return root, planted, names, onsets


def test_lab_ingest_matches_jax(lab, tmp_path):
    root, planted, names, onsets = lab
    eeg_fs = SMALL_LAB['eeg_fs']
    launches = fused_envelope_lagstack.launches
    got, stages, files = raw_recordings.lab_ingest(
        ingest, preprocess, root, str(tmp_path / 'port'), names, RATE,
        eeg_fs, device='cpu')
    assert fused_envelope_lagstack.launches == launches   # CPU: cumsum.
    want, _, jax_files = raw_recordings.lab_ingest(
        jax_ingest, jax_preprocess, root, str(tmp_path / 'jax'), names,
        RATE, eeg_fs)
    assert got == want
    for name, (mode, theil_sen, outliers, n_audio, n_eeg) in got.items():
        assert abs(mode - planted[name]) <= 1.0 / eeg_fs
        assert abs(theil_sen - planted[name]) <= 1.0 / eeg_fs
        assert outliers == 0
        assert n_audio == n_eeg == len(onsets[name])
    assert [os.path.basename(f) for f in files] == \
        [os.path.basename(f) for f in jax_files] == \
        ['trial_01.tfrecords', 'trial_02.tfrecords']
    for port_file, jax_file in zip(files, jax_files):
        port_data = records.read_tfrecords(port_file)
        jax_data = jax_records.read_tfrecords(jax_file)
        assert set(port_data) == set(jax_data) == {'eeg', 'intensity'}
        for k in jax_data:
            assert port_data[k].shape == jax_data[k].shape
            np.testing.assert_allclose(port_data[k], jax_data[k],
                                       atol=RECORD_TOL, rtol=0)
        assert port_data['eeg'].shape == (20 * RATE, 4)
    assert list(stages)[0] == 'wav and EDF read'


def test_planted_leads_and_events(lab):
    root, planted, _, onsets = lab
    for name, lead in planted.items():
        assert 0.25 <= lead <= 2.0
        assert len(onsets[name]) == 20 // SMALL_LAB['event_every']
    assert len(set(planted.values())) == len(planted)
    assert raw_recordings.brainvision_quanta(os.path.join(root, 'eeg')) \
        <= 1.0


def _decode(tf_dir, work, test_file):
    """cli.decoding.main on the CPU: CCA of eeg and intensity with the
    streamed fit, tested on ``test_file``; returns (the Final_Testing
    results, stdout, the model dir)."""
    summary, model_dir = os.path.join(work, 'summary'), os.path.join(
        work, 'model')
    pre, post, pre2, post2 = CONTEXTS
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = decoding.main([
            '--tfexample_dir', tf_dir, '--input_field', 'eeg',
            '--output_field', 'intensity', '--attended_field=',
            '--pre_context', str(pre), '--post_context', str(post),
            '--input2_field', 'intensity', '--input2_pre_context',
            str(pre2), '--input2_post_context', str(post2),
            '--train_file_pattern', 'allbut', '--validate_file_pattern',
            test_file, '--test_file_pattern', test_file,
            '--correlation_frames', '100', '--regularization_lambda',
            '0.001', '--dnn_regressor', 'cca', '--cca_dimensions', '2',
            '--streaming_fit', '--frame_rate', str(RATE), '--summary_dir',
            summary, '--saved_model_dir', model_dir, '--device', 'cpu'])
    assert rc == 0
    results = {}
    with open(os.path.join(summary, 'results.txt')) as f:
        for line in f:
            if line.startswith('Final_Testing/'):
                name, value = line.split(': ')
                results[name[len('Final_Testing/'):]] = float(value)
    return results, out.getvalue(), model_dir


def test_lab_records_decode(lab, tmp_path):
    root, _, names, _ = lab
    tf_dir = str(tmp_path / 'tf')
    raw_recordings.lab_ingest(ingest, preprocess, root, tf_dir, names,
                              RATE, SMALL_LAB['eeg_fs'], device='cpu')
    results, stdout, model_dir = _decode(tf_dir, str(tmp_path / 'work'),
                                         'trial_02')
    assert np.isfinite(results['dprime'])
    assert 'run_decoding_experiment timing:' in stdout
    decoder = create_decoder(model_dir, reduction='lda', device='cpu')
    decoder.load_decoding_model(model_dir)
    decoder.restore_parameters(os.path.join(model_dir,
                                            'decoder_model.json'))
    pre, post, pre2, post2 = CONTEXTS
    dataset = TFExampleData(
        'eeg', 'intensity', RATE, pre_context=pre, post_context=post,
        in2_fields='intensity', in2_pre_context=pre2,
        in2_post_context=post2, data_dir=tf_dir, device='cpu',
        test_file_pattern='trial_02', final_batch_size=512,
        shuffle_buffer_size=0).create_dataset('test')
    scores, _ = decoder.frame_scores(dataset)
    assert scores.shape == (512 * 2,)        # Whole 512-frame batches.
    assert np.all(np.isfinite(scores))


def test_check_leads_rejects_a_wrong_lead(lab):
    """chip_smoke.py's gate on the leads."""
    _, planted, _, onsets = lab
    name = sorted(planted)[0]
    n = len(onsets[name])
    good = {name: (planted[name], planted[name], 0, n, n)}
    chip_smoke.check_leads(good, planted, onsets, 512)
    for bad in ((planted[name] + 2.0 / 512, planted[name], 0, n, n),
                (planted[name], planted[name] - 2.0 / 512, 0, n, n),
                (planted[name], planted[name], 1, n, n),
                (planted[name], planted[name], 0, n, n - 1)):
        with pytest.raises(AssertionError):
            chip_smoke.check_leads({name: bad}, planted, onsets, 512)
