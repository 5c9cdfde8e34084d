"""The port's slices as a whole vs the JAX package, at small size.

Codelab slice: the same synthetic recordings
(chip_smoke.synthetic_recordings: EEG from the attended speaker through
a random TRF plus noise, a served stream whose attention switches at
its midpoint) go through

  JAX:  fit (stacked arrays) -> Decoder.train -> save -> serve_stream
  port: TFRecords -> TFExampleData -> fit_streaming (per-file lag stack)
        -> Decoder.train -> save -> cli.serve.main(argv) with an .npz

Ingest slice: a seeded KULeuven-shaped cache
(chip_smoke.build_kuleuven_cache, cut to a few 40 s trials) goes through

  JAX:  RegressionDataKULeuven.ingest_data -> TFExampleData ->
        fit_streaming -> Decoder.train -> save -> serve_stream
  port: chip_smoke.run_ingest_slice on the CPU (regression_data.main ->
        TFExampleData -> fit_streaming -> Decoder.train -> save ->
        cli.serve.main)

Decisions must be identical. Scores agree within 1e-3: the two fits
accumulate the moments in another order (per file vs concatenated) and
solve with different float32 LAPACK backends, which moves the rotations
by about 1e-5 relative; the served scores are window means of LDA
projections of order one.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from telluride_decoding_tpu.cli import regression_data as jax_rd
from telluride_decoding_tpu.cli import serve as jax_serve
from telluride_decoding_tpu.data import brain_data as jax_bd
from telluride_decoding_tpu.decode import infer_decoder as jax_infer
from telluride_decoding_tpu.models import BrainModelCCA as JaxCCA
from test_torch_infer_decoder import (jax_model_dir, port_model_dir,
                                      recordings)

import chip_smoke
from telluride_decoding_torch.cli import serve
from telluride_decoding_torch.ops.decode_kernel import fused_cca_decode
from telluride_decoding_torch.ops.fused_frontend import (
    fused_envelope_lagstack)
from telluride_decoding_torch.ops.lagstack import lag_stack

SLICE_TOL = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The ingest slice cut to size: one subject, 4 trials of 40 s, 8 EEG
# channels, 8 kHz audio; contexts (EEG pre, post, audio pre, post).
SMALL_KULEUVEN = dict(channels=8, audio_fs=8000, seconds=40, trials=4,
                      dims=3, contexts=(0, 4, 2, 2))


def test_slice_matches_jax(tmp_path):
    train, (eeg, a1, a2) = recordings()
    jax_dir, port_dir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    jax_dprime = jax_model_dir(jax_dir, train)
    port_dprime = port_model_dir(port_dir, train)
    assert port_dprime == pytest.approx(jax_dprime, rel=1e-3)

    want = jax_serve.serve_stream(jax_dir, eeg, a1, a2, chunk_size=32,
                                  reduction='lda', decision='wta',
                                  window_width=100, window_step=50)
    stream = str(tmp_path / 'stream.npz')
    out = str(tmp_path / 'decisions.jsonl')
    np.savez(stream, eeg=eeg, audio1=a1, audio2=a2)
    serve.main(['--serve_model_dir', port_dir, '--serve_input', stream,
                '--serve_output', out, '--chunk_size', '32',
                '--serve_window_width', '100', '--serve_window_step', '50',
                '--serve_decoder', 'wta', '--serve_device', 'cpu'])
    with open(out) as f:
        got = [json.loads(line) for line in f][:-1]
    assert [(d['window'], d['attend_speaker1']) for d in got] == \
        [(d['window'], d['attend_speaker1']) for d in want]
    for g, w in zip(got, want):
        assert g['score1'] == pytest.approx(w['score1'], abs=SLICE_TOL)
        assert g['score2'] == pytest.approx(w['score2'], abs=SLICE_TOL)
    # The planted switch is found (the chip smoke test's own check).
    chip_smoke.check_decisions(want, {'windows': len(want)},
                               stream_frames=eeg.shape[0])


def _jax_ingest_slice(tmp_path, held_out):
    """The ingest slice in the JAX package, on the cache that
    run_ingest_slice built; returns its served decisions."""
    sizes = dict(chip_smoke.KULEUVEN, **SMALL_KULEUVEN)
    pre, post, pre2, post2 = sizes['contexts']
    cache = str(tmp_path / 'kuleuven_cache')
    tf_dir = str(tmp_path / 'jax_tf')
    # The JAX ingest reads all 16 subjects; the others are copies of S1.
    for sid in range(2, 17):
        shutil.copy(os.path.join(cache, 'S1.mat'),
                    os.path.join(cache, 'S%d.mat' % sid))
    jax_rd.RegressionDataKULeuven().ingest_data(cache, tf_dir, 32)
    pattern = held_out + r'\.tfrecords'

    def data(in2):
        return jax_bd.TFExampleData(
            'eeg', 'intensity', 32, pre_context=pre, post_context=post,
            in2_fields=in2, in2_pre_context=pre2, in2_post_context=post2,
            data_dir=os.path.join(tf_dir, 'S1'), train_file_pattern='allbut',
            validate_file_pattern=pattern, test_file_pattern=pattern)

    def batches(brain_data):
        return [({'input_1': in1, 'input_2': in2}, out) for _, (
            in1, in2, out, _) in brain_data.iter_file_arrays('train')]
    attended, unattended = data('intensity'), data('intensity2')
    width1 = attended.input_fields_width(1)
    model = JaxCCA(cca_dims=sizes['dims'], regularization_lambda=1e-3,
                   input1_width=width1,
                   input2_width=attended.input_fields_width(2))
    model.fit_streaming(attended, 'train')
    decoder = jax_infer.CCADecoder(model, reduction='lda')
    decoder.train(batches(unattended), batches(attended), window_size=100)
    model_dir = str(tmp_path / 'jax_model')
    model.add_metadata({'pre_context': pre, 'post_context': post,
                        'input2_pre_context': pre2,
                        'input2_post_context': post2,
                        'dnn_regressor': 'cca'})
    model.save(model_dir)
    decoder.save_parameters(os.path.join(model_dir, 'decoder_model.json'))
    from telluride_decoding_tpu.data import records as jax_records
    held = jax_records.read_tfrecords(
        os.path.join(tf_dir, 'S1', held_out + '.tfrecords'))
    return jax_serve.serve_stream(model_dir, held['eeg'], held['intensity'],
                                  held['intensity2'], chunk_size=32,
                                  reduction='lda', decision='wta',
                                  window_width=100, window_step=50,
                                  frame_rate=32)


def test_ingest_slice_matches_jax(tmp_path):
    """Raw recordings -> TFRecords -> fit -> train -> serve, in both
    packages on the CPU: the same decisions, scores within 1e-3."""
    launches = fused_envelope_lagstack.launches
    got, summary, stream, times, _, _ = chip_smoke.run_ingest_slice(
        'cpu', str(tmp_path), **SMALL_KULEUVEN)
    assert fused_envelope_lagstack.launches == launches
    assert times['files'] == SMALL_KULEUVEN['trials']
    assert times['ingest_err'] == 0.0         # Both ingests on the CPU.
    assert chip_smoke.check_decisions(got, summary, stream[0].shape[0],
                                      32) > 0.9
    want = _jax_ingest_slice(tmp_path, 'S1_T%d'
                             % (SMALL_KULEUVEN['trials'] - 1))
    assert [(d['window'], d['attend_speaker1']) for d in got] == \
        [(d['window'], d['attend_speaker1']) for d in want]
    for g, w in zip(got, want):
        assert g['score1'] == pytest.approx(w['score1'], abs=SLICE_TOL)
        assert g['score2'] == pytest.approx(w['score2'], abs=SLICE_TOL)


def test_chip_smoke_slice_runs_on_cpu(tmp_path):
    """chip_smoke's codelab phase at a small size with the plain
    versions: CPU tensors never launch a kernel."""
    launches = (lag_stack.launches, fused_cca_decode.launches)
    contexts = (0, 4, 2, 2)
    decisions, summary, stream, _ = chip_smoke.run_slice(
        'cpu', str(tmp_path), channels=12, files=2, frames=3000,
        stream_frames=3000, dims=4, contexts=contexts)
    assert chip_smoke.check_decisions(decisions, summary, 3000) > 0.9
    assert chip_smoke.check_against_plain(decisions, str(tmp_path), stream,
                                          contexts) <= chip_smoke.SERVE_TOL
    assert (lag_stack.launches, fused_cca_decode.launches) == launches


def test_chip_smoke_fails_without_card_and_alone():
    """No card: non-zero exit, no result. Alone in a directory: the same,
    whatever the machine."""
    proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    with tempfile.TemporaryDirectory() as alone:
        with open(os.path.join(REPO, 'chip_smoke.py')) as f:
            source = f.read()
        with open(os.path.join(alone, 'chip_smoke.py'), 'w') as f:
            f.write(source)
        env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
        proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=alone,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
