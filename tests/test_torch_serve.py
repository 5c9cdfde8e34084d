"""Streaming server of the PyTorch port vs the JAX package's tdt-serve.

Both serve the same JAX-written model directory and the same stream;
decisions must be identical and the window scores equal within 1e-4
(the float32 bound of the fused decode, tests/test_decode_kernel.py;
the scores are written rounded to 6 decimals)."""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from telluride_decoding_tpu.cli import serve as jax_serve
from telluride_decoding_torch.cli import serve
from test_torch_infer_decoder import jax_model_dir, recordings

SCORE_TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same_decisions(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g['window'] == w['window']
        assert g['time_s'] == w['time_s']
        assert g['attend_speaker1'] == w['attend_speaker1']
        assert g['score1'] == pytest.approx(w['score1'], abs=SCORE_TOL)
        assert g['score2'] == pytest.approx(w['score2'], abs=SCORE_TOL)


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    """A JAX-written model dir and a stream with a planted switch."""
    path = str(tmp_path_factory.mktemp('model'))
    train, stream = recordings()
    jax_model_dir(path, train)
    return path, stream


@pytest.mark.parametrize('pre,post,chunks', [(0, 0, [7, 5, 9]),
                                             (2, 4, [1, 9, 3, 8]),
                                             (5, 5, [30])])
def test_context_buffer_matches_jax(rng, pre, post, chunks):
    x = rng.randn(sum(chunks), 3).astype(np.float32)
    got_buf = serve.ContextBuffer(3, pre, post)
    want_buf = jax_serve.ContextBuffer(3, pre, post)
    start = 0
    for c in chunks:
        np.testing.assert_array_equal(got_buf.push(x[start:start + c]),
                                      want_buf.push(x[start:start + c]))
        start += c


@pytest.mark.parametrize('decision', ['wta', 'stepped'])
def test_serve_stream_matches_jax(served, decision):
    path, (eeg, a1, a2) = served
    kwargs = dict(chunk_size=32, reduction='lda', decision=decision,
                  window_width=100, window_step=50)
    got = serve.serve_stream(path, eeg, a1, a2, device='cpu', **kwargs)
    want = jax_serve.serve_stream(path, eeg, a1, a2, **kwargs)
    assert_same_decisions(got, want)


def test_serve_lines_matches_serve_stream(served):
    path, (eeg, a1, a2) = served
    lines = io.StringIO()
    for start in range(0, eeg.shape[0], 50):
        sl = slice(start, start + 50)
        lines.write(json.dumps({'eeg': eeg[sl].tolist(),
                                'audio1': a1[sl, 0].tolist(),
                                'audio2': a2[sl].tolist()}) + '\n')
        if start == 100:
            lines.write('not json\n{}\n')
    lines.seek(0)
    got = serve.serve_lines(path, lines, device='cpu')
    want = serve.serve_stream(path, eeg, a1, a2, device='cpu')
    assert [d['attend_speaker1'] for d in got] == \
        [d['attend_speaker1'] for d in want]
    for g, w in zip(got, want):
        assert g['score1'] == w['score1'] and g['score2'] == w['score2']


def test_main_replays_npz(served, tmp_path):
    path, (eeg, a1, a2) = served
    stream = str(tmp_path / 'stream.npz')
    out = str(tmp_path / 'decisions.jsonl')
    np.savez(stream, eeg=eeg, audio1=a1, audio2=a2[:, 0])
    assert serve.main(['--serve_model_dir', path, '--serve_input', stream,
                       '--serve_output', out, '--serve_device', 'cpu']) == 0
    with open(out) as f:
        lines = [json.loads(line) for line in f]
    assert lines[-1]['summary'] and lines[-1]['windows'] == len(lines) - 1
    assert_same_decisions(lines[:-1], jax_serve.serve_stream(
        path, eeg, a1, a2, chunk_size=32, reduction='lda'))


def test_main_refuses_tcp(served):
    with pytest.raises(SystemExit):
        serve.main(['--serve_model_dir', served[0], '--serve_input',
                    'tcp://localhost:0', '--serve_device', 'cpu'])


def test_import_leaves_jax_out():
    """The port's entry point imports neither jax nor the JAX package."""
    code = (
        'import sys\n'
        'for name in list(sys.modules):\n'
        '    if name.split(".")[0] in ("jax", "jaxlib", '
        '"telluride_decoding_tpu"):\n'
        '        del sys.modules[name]\n'
        'import telluride_decoding_torch.cli.serve\n'
        'import telluride_decoding_torch.cli.regression_data\n'
        'import telluride_decoding_torch.cli.regression\n'
        'import telluride_decoding_torch.cli.cohort\n'
        'import telluride_decoding_torch.parallel.multihost\n'
        'import telluride_decoding_torch.sweep.engine\n'
        'import telluride_decoding_torch.sweep.checkpoint\n'
        'import telluride_decoding_torch.utils.csv_util\n'
        'import telluride_decoding_torch.utils.plot_util\n'
        'import telluride_decoding_torch.utils.results\n'
        'import telluride_decoding_torch.utils.stdio\n'
        'import telluride_decoding_torch.data.records\n'
        'import telluride_decoding_torch.io.ingest\n'
        'import telluride_decoding_torch.models.convert\n'
        'import telluride_decoding_torch.signal.audio_stores\n'
        'import telluride_decoding_torch.signal.preprocess\n'
        'bad = sorted(n for n in sys.modules if n.split(".")[0] in '
        '("jax", "jaxlib", "telluride_decoding_tpu", "absl"))\n'
        'assert not bad, bad\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout
