"""Streaming server of the PyTorch port vs the JAX package's tdt-serve.

Both serve the same JAX-written model directory and the same stream;
decisions must be identical and the window scores equal within 1e-4
(the float32 bound of the fused decode, tests/test_decode_kernel.py;
the scores are written rounded to 6 decimals). The TCP tests run the
port's listener on a thread on loopback, as the JAX suite's
TestServeSocket does."""

import io
import json
import os
import queue
import socket
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from telluride_decoding_tpu.cli import serve as jax_serve
from telluride_decoding_torch import kernels
from telluride_decoding_torch.cli import serve
from telluride_decoding_torch.ops.lagstack import LagRows, lag_stack_np
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


# The last cases are codelab widths: 69 EEG channels with 36 frames of
# post context, one audio channel with 15 frames either side.
@pytest.mark.parametrize('pre,post,chunks,channels', [
    (0, 0, [7, 5, 9], 3), (2, 4, [1, 9, 3, 8], 3), (5, 5, [30], 3),
    (0, 36, [32] * 6, 69), (0, 36, [5, 40, 1, 33, 64, 32], 69),
    (15, 15, [32] * 4, 1), (15, 15, [3, 16, 29, 1, 32], 1)], ids=[
        '0-0-chunks0', '2-4-chunks1', '5-5-chunks2', 'codelab-eeg',
        'codelab-eeg-ragged', 'codelab-audio', 'codelab-audio-ragged'])
def test_context_buffer_matches_jax(rng, pre, post, chunks, channels):
    """Each push's window holds the rows the JAX package's buffer
    stacks, and np.asarray of it gives the offline lag stack's rows of
    the stream, bit for bit."""
    x = rng.randn(sum(chunks), channels).astype(np.float32)
    offline = lag_stack_np(x, pre, post)
    got_buf = serve.ContextBuffer(channels, pre, post)
    want_buf = jax_serve.ContextBuffer(channels, pre, post)
    start = emitted = 0
    for c in chunks:
        got = got_buf.push(x[start:start + c])
        assert isinstance(got, LagRows)
        rows = np.asarray(got)
        assert rows.dtype == np.float32 and rows.shape == got.shape
        np.testing.assert_array_equal(rows, want_buf.push(x[start:start + c]))
        np.testing.assert_array_equal(rows,
                                      offline[emitted:emitted + len(got)])
        emitted += len(got)
        start += c
    assert emitted == max(0, sum(chunks) - post)


@pytest.mark.parametrize('pre,post', [(0, 36), (2, 3), (3, 0)])
def test_context_buffer_out_of_step_gives_the_host_stacks_rows(rng, pre,
                                                               post):
    """A buffer whose state was moved out of step (its frames held back
    after each push, so it holds fewer than its counts say) gives the
    rows the host stack gave the frames it holds, with zeros past their
    end, bit for bit, and no more rows than those."""
    channels = 2
    buf = serve.ContextBuffer(channels, pre, post)
    for c in [5, 32, 1, 40, 32, 64]:
        frames = rng.randn(c, channels).astype(np.float32)
        kept = buf._buf
        held = np.concatenate([kept, frames])
        avail = buf._arrived + c - post - buf._emitted
        want = lag_stack_np(held[:max(avail, 0) + pre + post], pre,
                            post)[pre:pre + max(avail, 0)]
        got = buf.push(frames)
        assert got.shape == want.shape
        np.testing.assert_array_equal(np.asarray(got), want)
        buf._buf = kept


class HostStackedServer(serve.StreamingAttentionServer):
    """The server with each push's rows stacked on the host from the
    whole streams received so far (lag_stack_np): the rows every stream
    has completed since the last push, as arrays."""

    def _context_rows(self, eeg, audio1, audio2):
        chunks = [np.atleast_2d(np.asarray(x, np.float32))
                  for x in (eeg, audio1, audio2)]
        self._seen = [np.concatenate([s, c]) for s, c in zip(
            getattr(self, '_seen', [c[:0] for c in chunks]), chunks)]
        lags = [(b._pre, b._post)
                for b in (self._ctx_eeg, self._ctx_a1, self._ctx_a2)]
        start = getattr(self, '_done', 0)
        done = min(len(s) - post for s, (_, post) in zip(self._seen, lags))
        if done <= start:
            return None
        self._done = done
        rows = [lag_stack_np(s, pre, post)[start:done]
                for s, (pre, post) in zip(self._seen, lags)]
        return tuple(rows) + tuple(s[start:done] for s in self._seen[1:])


def _context_decoder(eeg_channels, eeg_pre, eeg_post, audio_pre,
                     audio_post, dims=3):
    """A CCA decoder with the LDA reduction on seeded weights, for
    these lags."""
    from telluride_decoding_torch.decode.infer_decoder import (
        CCADecoder, CorrelationParamsTuple, ModelParamsTuple)
    from telluride_decoding_torch.models.cca import BrainModelCCA
    from telluride_decoding_torch.solvers.lda import LdaParams
    rng = np.random.RandomState(4)
    f1 = eeg_channels * (eeg_pre + 1 + eeg_post)
    f2 = audio_pre + 1 + audio_post
    model = BrainModelCCA.from_numpy(
        {'mean1': 0.1 * rng.randn(1, f1), 'mean2': 0.1 * rng.randn(1, f2),
         'rot1': rng.randn(f1, dims) / np.sqrt(f1),
         'rot2': rng.randn(f2, dims) / np.sqrt(f2)}, 'cpu')
    decoder = CCADecoder(model, reduction='lda', device='cpu')
    zeros = np.zeros(dims)
    decoder.model_params = ModelParamsTuple(
        CorrelationParamsTuple(1, zeros, zeros, zeros, zeros,
                               0.1 * rng.randn(dims), 0.1 * rng.randn(dims),
                               1.0 + rng.rand(dims)),
        LdaParams(rng.randn(dims, 1), np.zeros((dims, 1)), np.array([0, 1]),
                  np.zeros((2, dims)), 0.1, 0.5))
    decoder.decoding_model_params = {
        'pre_context': eeg_pre, 'post_context': eeg_post,
        'input2_pre_context': audio_pre, 'input2_post_context': audio_post}
    return decoder


@pytest.mark.parametrize('pipeline', [False, True])
@pytest.mark.parametrize('lags', [(0, 36, 15, 15), (2, 3, 0, 9)])
def test_raw_windows_join_and_split_as_host_stacks(rng, lags, pipeline):
    """EEG and audio post contexts that differ (36 against 15 at
    codelab widths; the audio's the longer in the second case): one
    stream's completed rows wait for the others', so its pending raw
    windows join across pushes and split at each decode. The decoder
    gets the host-stacked server's rows, bit for bit, and the same
    decisions come out."""
    channels = 4
    decoder = _context_decoder(channels, *lags)
    chunks = [5, 32, 1, 40, 32, 17, 32, 64, 3, 32, 32, 100, 32]
    eeg = rng.randn(sum(chunks), channels).astype(np.float32)
    a1, a2 = (rng.randn(sum(chunks), 1).astype(np.float32)
              for _ in range(2))
    runs = []
    for kind in (serve.StreamingAttentionServer, HostStackedServer):
        server = kind(decoder, eeg_channels=channels, window_width=40,
                      window_step=20, pipeline=pipeline)
        calls = []
        name = 'infer_pair_async' if pipeline else 'infer_pair'
        infer = getattr(decoder, name)

        def taped(*args, infer=infer, calls=calls):
            calls.append([np.asarray(a) for a in args])
            return infer(*args)
        setattr(decoder, name, taped)
        decisions, start = [], 0
        for c in chunks:
            decisions += server.push(eeg[start:start + c],
                                     a1[start:start + c], a2[start:start + c])
            start += c
        decisions += server.flush()
        delattr(decoder, name)
        runs.append((calls, decisions))
    (got_calls, got), (want_calls, want) = runs
    assert len(got_calls) == len(want_calls) > 5
    for g, w in zip(got_calls, want_calls):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        g.pop('latency_ms'), w.pop('latency_ms')
        assert g == w


@pytest.mark.parametrize('decision', ['wta', 'stepped', 'ssd'])
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


@pytest.mark.parametrize('address', ['tcp://nohost', 'tcp://h:notaport',
                                     'tcp://:-5'])
def test_main_refuses_tcp(served, address):
    """main refuses a TCP address it cannot parse before it listens."""
    with pytest.raises(SystemExit):
        serve.main(['--serve_model_dir', served[0], '--serve_input',
                    address, '--serve_device', 'cpu'])


def test_import_leaves_jax_out():
    """The port's modules import neither jax nor the JAX package, nor
    pandas or h5py (the model-file modules included: h5py is imported
    only when an .h5 file is written)."""
    code = (
        'import sys\n'
        'for name in list(sys.modules):\n'
        '    if name.split(".")[0] in ("jax", "jaxlib", '
        '"telluride_decoding_tpu"):\n'
        '        del sys.modules[name]\n'
        'import telluride_decoding_torch.cli.serve\n'
        'import telluride_decoding_torch.cli.infer\n'
        'import telluride_decoding_torch.decide.attention_decoder\n'
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
        'import telluride_decoding_torch.io.edf\n'
        'import telluride_decoding_torch.io.brainvision\n'
        'import telluride_decoding_torch.cli.add_trigger\n'
        'import telluride_decoding_torch.models.convert\n'
        'import telluride_decoding_torch.signal.audio_stores\n'
        'import telluride_decoding_torch.signal.preprocess\n'
        'import telluride_decoding_torch.io.tf_checkpoint\n'
        'import telluride_decoding_torch.io.keras_h5\n'
        'import telluride_decoding_torch.io.saved_model_pb\n'
        'import telluride_decoding_torch.models.migrate\n'
        'import telluride_decoding_torch.cli.migrate_saved_model\n'
        'import telluride_decoding_torch.cli.export_keras\n'
        'bad = sorted(n for n in sys.modules if n.split(".")[0] in '
        '("jax", "jaxlib", "telluride_decoding_tpu", "absl", "pandas", '
        '"h5py"))\n'
        'assert not bad, bad\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout


def _lines(stream, step=50, frames=None):
    eeg, a1, a2 = stream
    frames = eeg.shape[0] if frames is None else frames
    return [json.dumps({'eeg': eeg[s:s + step].tolist(),
                        'audio1': a1[s:s + step].tolist(),
                        'audio2': a2[s:s + step].tolist()})
            for s in range(0, frames, step)]


def test_pipelined_replay_equals_synchronous(served):
    """--serve_pipeline harvests each chunk one push later: the same
    decisions, and latency counts from the push that dispatched the
    windows' chunk, so it is never zero by construction."""
    path, (eeg, a1, a2) = served
    kwargs = dict(device='cpu', chunk_size=150, window_width=100,
                  window_step=100)
    piped = serve.serve_stream(path, eeg, a1, a2, pipeline=True, **kwargs)
    sync = serve.serve_stream(path, eeg, a1, a2, **kwargs)
    assert [d['score1'] for d in piped] == [d['score1'] for d in sync]
    assert [d['attend_speaker1'] for d in piped] == \
        [d['attend_speaker1'] for d in sync]
    assert all(d['latency_ms'] > 0 for d in piped)


def test_flush_harvests_the_last_chunk(served):
    path, (eeg, a1, a2) = served
    decoder = serve.load_model(path, 'lda', 'cpu')
    server = serve.StreamingAttentionServer(
        decoder, eeg_channels=eeg.shape[1], window_width=100,
        window_step=100, pipeline=True)
    pushed = server.push(eeg[:300], a1[:300], a2[:300])
    assert pushed == []            # The chunk is still in flight.
    flushed = server.flush()
    assert len(flushed) == 2 and server.flush() == []
    sync = serve.StreamingAttentionServer(
        decoder, eeg_channels=eeg.shape[1], window_width=100,
        window_step=100)
    want = sync.push(eeg[:300], a1[:300], a2[:300])
    assert [d['score1'] for d in flushed] == [d['score1'] for d in want]


def test_infer_pair_async_on_cpu_returns_the_arrays(served):
    path, (eeg, a1, a2) = served
    decoder = serve.load_model(path, 'lda', 'cpu')
    x1 = lag_stack_np(eeg[:200], 0, 4)
    x2a, x2b = lag_stack_np(a1[:200], 2, 2), lag_stack_np(a2[:200], 2, 2)
    got = decoder.infer_pair_async(x1, x2a, x2b, a1[:200], a2[:200])
    want = decoder.infer_pair(x1, x2a, x2b, a1[:200], a2[:200])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


def _upper_case_chunk(stream):
    """A chunk from a client that spells the field names in capitals."""
    return json.dumps({'EEG': stream[0][:50].tolist(),
                       'AUDIO1': stream[1][:50].tolist(),
                       'AUDIO2': stream[2][:50].tolist()})


def test_misspelled_key_is_reported(served, capsys):
    """A chunk with a misspelled field is a bad line, reported on stderr;
    only three present and empty fields make a keepalive."""
    path, stream = served
    lines = _lines(stream, frames=200)
    bad = _upper_case_chunk(stream)
    keepalive = json.dumps({'eeg': [], 'audio1': [], 'audio2': []})
    got = serve.serve_lines(path, io.StringIO('\n'.join(
        [keepalive, lines[0], bad, keepalive] + lines[1:]) + '\n'),
        device='cpu')
    err = capsys.readouterr().err
    assert err.count('skipping bad input line') == 1 and "'eeg'" in err
    want = serve.serve_lines(path, io.StringIO('\n'.join(lines) + '\n'),
                             device='cpu')
    assert [d['score1'] for d in got] == [d['score1'] for d in want]


def test_jax_drops_a_misspelled_key_silently(served, capsys):
    """The reference fault the port does not copy: JAX serve_lines takes
    {"EEG": ..., "AUDIO1": ..., "AUDIO2": ...} for a keepalive and skips it without a word
    (telluride_decoding_tpu/cli/serve.py:463-471)."""
    path, stream = served
    bad = _upper_case_chunk(stream)
    bad_audio = json.dumps({'eeg': stream[0][:50].tolist(),
                            'Audio1': stream[1][:50].tolist(),
                            'audio2': stream[2][:50].tolist()})
    assert jax_serve.serve_lines(path, io.StringIO(bad + '\n')) == []
    assert capsys.readouterr().err == ''
    # A chunk whose eeg is there does reach the error path in JAX.
    jax_serve.serve_lines(path, io.StringIO(bad_audio + '\n'))
    assert 'skipping bad input line' in capsys.readouterr().err


# A JSON integer too large for float32: np.asarray(..., np.float32)
# raises OverflowError on it.
OVERSIZED = '{"eeg": [1' + '0' * 400 + '], "audio1": [1], "audio2": [1]}'
ALL_NULL = '{"eeg": null, "audio1": null, "audio2": null}'


def _scores(decisions):
    return [(d['score1'], d['score2']) for d in decisions]


@pytest.mark.parametrize('bad', [OVERSIZED, ALL_NULL])
def test_bad_line_is_reported_and_skipped(served, capsys, bad):
    """An oversized number and an all-null chunk are bad lines: reported
    on stderr, no frame pushed, the session goes on."""
    path, stream = served
    lines = _lines(stream, frames=200)
    got = serve.serve_lines(path, io.StringIO('\n'.join(
        [lines[0], bad] + lines[1:]) + '\n'), device='cpu')
    err = capsys.readouterr().err
    assert err.count('skipping bad input line') == 1
    want = serve.serve_lines(path, io.StringIO('\n'.join(lines) + '\n'),
                             device='cpu')
    assert _scores(got) == _scores(want) and len(got) >= 2
    assert np.all(np.isfinite(_scores(got)))


@pytest.mark.parametrize('bad', [OVERSIZED, ALL_NULL])
def test_jax_skips_the_bad_line(served, bad):
    """The JAX server skips both lines too (the oversized number on its
    error path, the all-null chunk as a keepalive,
    telluride_decoding_tpu/cli/serve.py:463-478), so the two packages
    serve the same decisions around them."""
    path, stream = served
    lines = _lines(stream, frames=200)
    text = '\n'.join([lines[0], bad] + lines[1:]) + '\n'
    got = serve.serve_lines(path, io.StringIO(text), device='cpu')
    want = jax_serve.serve_lines(path, io.StringIO(text))
    assert_same_decisions(got, want)


def test_single_null_field_is_reported(served, capsys):
    path, stream = served
    lines = _lines(stream, frames=200)
    eeg, _, a2 = stream
    bad = json.dumps({'eeg': eeg[:1].tolist(), 'audio1': None,
                      'audio2': a2[:1].tolist()})
    got = serve.serve_lines(path, io.StringIO('\n'.join(
        [lines[0], bad] + lines[1:]) + '\n'), device='cpu')
    err = capsys.readouterr().err
    assert err.count('skipping bad input line') == 1 and 'null' in err
    want = serve.serve_lines(path, io.StringIO('\n'.join(lines) + '\n'),
                             device='cpu')
    assert _scores(got) == _scores(want)


def test_jax_serves_a_single_null_field_as_a_nan_frame(served, capsys):
    """The shared reference fault the port does not copy: in a one-frame
    mono chunk, JAX turns a null audio field into np.asarray(None,
    float32), one NaN frame (telluride_decoding_tpu/cli/serve.py:417-423),
    and pushes it; the windows that hold it score NaN and every later
    window is shifted by one frame."""
    path, stream = served
    lines = _lines(stream, frames=200)
    eeg, _, a2 = stream
    bad = json.dumps({'eeg': eeg[:1].tolist(), 'audio1': None,
                      'audio2': a2[:1].tolist()})
    got = jax_serve.serve_lines(path, io.StringIO('\n'.join(
        [lines[0], bad] + lines[1:]) + '\n'))
    assert capsys.readouterr().err == ''
    assert any(np.isnan(d['score1']) for d in got)


class _FailingLibrary:
    """Stands in for the kernel library: every code is a CUDA error."""

    @staticmethod
    def tdt_error_string(code):
        return b'an illegal memory access was encountered'


def _kernel_fails():
    kernels.check(700, 'fused_cca_decode')


def _torch_op_fails():
    raise torch.AcceleratorError('CUDA error: an illegal memory access was '
                                 'encountered')


def _fail_every_push(monkeypatch, fail):
    monkeypatch.setattr(kernels, 'library', lambda: _FailingLibrary)
    monkeypatch.setattr(serve.StreamingAttentionServer, 'push',
                        lambda self, eeg, audio1, audio2: fail())


@pytest.mark.parametrize('fail', [_kernel_fails, _torch_op_fails],
                         ids=['kernel', 'torch_op'])
def test_failing_launch_ends_serve_lines(served, monkeypatch, capsys, fail):
    """A failure of the card is not a bad chunk: serve_lines raises
    instead of skipping every chunk and serving nothing."""
    path, stream = served
    lines = _lines(stream, frames=200)
    _fail_every_push(monkeypatch, fail)
    with pytest.raises(serve.DEVICE_ERRORS, match='illegal memory access'):
        serve.serve_lines(path, io.StringIO('\n'.join(lines) + '\n'),
                          device='cpu')
    assert 'skipping' not in capsys.readouterr().err


def test_bad_chunk_content_is_still_skipped(served, monkeypatch, capsys):
    """Errors other than the card's (here an OverflowError out of push)
    skip the chunk, as the JAX server does."""
    path, stream = served
    lines = _lines(stream, frames=200)
    real_push = serve.StreamingAttentionServer.push
    calls = []

    def push(self, eeg, audio1, audio2):
        calls.append(1)
        if len(calls) == 2:
            raise OverflowError('int too large to convert to float')
        return real_push(self, eeg, audio1, audio2)
    monkeypatch.setattr(serve.StreamingAttentionServer, 'push', push)
    got = serve.serve_lines(path, io.StringIO('\n'.join(lines) + '\n'),
                            device='cpu')
    assert capsys.readouterr().err.count('skipping bad chunk') == 1
    assert len(calls) == len(lines) and len(got) >= 1


class _Probability:
    """A decision rule that answers with a probability, as ssd does."""

    def __init__(self, p):
        self.p = p

    def attention(self, r1, r2):
        del r1, r2
        return self.p, self.p - 0.1, self.p + 0.1


@pytest.mark.parametrize('p,want', [(0.3, False), (0.5, True), (0.7, True)])
def test_attend_speaker1_thresholds_a_probability(served, p, want):
    path, (eeg, a1, a2) = served
    server = serve.StreamingAttentionServer(
        serve.load_model(path, 'lda', 'cpu'), eeg_channels=eeg.shape[1],
        window_width=100, window_step=100)
    server._decide = _Probability(p)
    decisions = server.push(eeg[:300], a1[:300], a2[:300])
    assert decisions and all(d['attend_speaker1'] is want
                             for d in decisions)


def test_aot_artifact_is_refused(served, tmp_path):
    """An artifact of the JAX package (a StableHLO program) is refused,
    with the tool that re-exports its model directory for the port."""
    from telluride_decoding_tpu.cli.infer import load_model as jax_load
    from telluride_decoding_tpu.decode import aot as jax_aot
    artifact = str(tmp_path / 'jax_artifact')
    jax_aot.export_decoder(jax_load(served[0], 'lda'), artifact,
                           platforms=('cpu',), input_widths=(40, 5),
                           output_width=1)
    with pytest.raises(ValueError, match='StableHLO, which PyTorch cannot '
                                         'run') as error:
        serve._load_serving_decoder(artifact, None, 'cpu')
    assert 'python -m telluride_decoding_torch.cli.export_aot' in \
        str(error.value)


@pytest.fixture(scope='module')
def port_artifact(served, tmp_path_factory):
    """The port's AOT artifact of the served model dir (reduction lda)."""
    from telluride_decoding_torch.cli import export_aot
    artifact = str(tmp_path_factory.mktemp('artifact') / 'cca')
    export_aot.app_main([served[0], artifact, '--device', 'cpu',
                         '--input_widths', '40,5', '--output_width', '1'])
    return artifact


@pytest.mark.parametrize('pipeline', [False, True])
def test_main_replays_npz_from_an_artifact(served, port_artifact, tmp_path,
                                           pipeline):
    """cli.serve.main on the port's artifact: the model directory's
    decisions and scores (the same decode on the CPU)."""
    path, (eeg, a1, a2) = served
    stream = str(tmp_path / 'stream.npz')
    out = str(tmp_path / 'decisions.jsonl')
    np.savez(stream, eeg=eeg, audio1=a1, audio2=a2)
    assert serve.main(['--serve_model_dir', port_artifact, '--serve_input',
                       stream, '--serve_output', out, '--serve_device', 'cpu']
                      + ['--serve_pipeline'] * pipeline) == 0
    with open(out) as f:
        lines = [json.loads(line) for line in f]
    assert lines[-1]['windows'] == len(lines) - 1
    want = serve.serve_stream(path, eeg, a1, a2, device='cpu')
    assert [(d['score1'], d['score2'], d['attend_speaker1'])
            for d in lines[:-1]] == [
        (d['score1'], d['score2'], d['attend_speaker1']) for d in want]


def test_serve_lines_from_an_artifact(served, port_artifact):
    path, stream = served
    lines = '\n'.join(_lines(stream, frames=600)) + '\n'
    got = serve.serve_lines(port_artifact, io.StringIO(lines), device='cpu')
    want = serve.serve_lines(path, io.StringIO(lines), device='cpu')
    assert len(got) == len(want) >= 5
    assert [d['score1'] for d in got] == [d['score1'] for d in want]


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_conflicting_reduction_refused_by_artifact(served, port_artifact,
                                                   tmp_path, package):
    """An explicit reduction other than the artifact's is refused with
    the JAX text; the artifact's own, or none, serves."""
    if package == 'jax':
        from telluride_decoding_tpu.cli.infer import load_model as jax_load
        from telluride_decoding_tpu.decode import aot as jax_aot
        artifact = str(tmp_path / 'jax_artifact')
        jax_aot.export_decoder(jax_load(served[0], 'lda'), artifact,
                               platforms=('cpu',), input_widths=(40, 5),
                               output_width=1)
        load = lambda r: jax_serve._load_serving_decoder(artifact, r)
    else:
        load = lambda r: serve._load_serving_decoder(port_artifact, r,
                                                     'cpu')
    with pytest.raises(ValueError, match="exported with reduction 'lda'; "
                                         "requested 'first'"):
        load('first')
    assert load('lda').reduction == load(None).reduction == 'lda'


def test_only_an_explicit_reduction_is_a_request(served, monkeypatch):
    called = []
    monkeypatch.setattr(serve, 'serve_socket',
                        lambda *a, **k: called.append(k))
    argv = ['--serve_model_dir', served[0], '--serve_input',
            'tcp://127.0.0.1:0', '--serve_device', 'cpu']
    serve.main(argv)
    serve.main(argv + ['--serve_reduction', 'first'])
    assert [k['reduction'] for k in called] == [None, 'first']
    assert serve._load_serving_decoder(served[0], None, 'cpu') \
        ._reduction == 'lda'


def test_tcp_mode_leaves_serve_output_untouched(served, tmp_path,
                                                monkeypatch):
    out = tmp_path / 'decisions.jsonl'
    out.write_text('{"precious": 1}\n')
    called = []
    monkeypatch.setattr(serve, 'serve_socket',
                        lambda *a, **k: called.append(k))
    assert serve.main(['--serve_model_dir', served[0], '--serve_input',
                       'tcp://127.0.0.1:0', '--serve_output', str(out),
                       '--serve_device', 'cpu',
                       '--serve_idle_timeout_s', '2.5']) == 0
    assert called and called[0]['idle_timeout_s'] == 2.5
    assert out.read_text() == '{"precious": 1}\n'


def test_selftest_main(capsys):
    assert serve.main(['--selftest', '--serve_device', 'cpu']) == 0
    assert 'selftest: 60 windows' in capsys.readouterr().err


class TestServeSocket:
    """The TCP listener against serve_lines, on loopback."""

    @staticmethod
    def _start(model_dir, max_sessions, address='tcp://127.0.0.1:0',
               **kw):
        bound = queue.Queue()
        box = {}

        def run():
            try:
                box['counts'] = serve.serve_socket(
                    model_dir, address, device='cpu',
                    max_sessions=max_sessions,
                    on_bound=lambda h, p: bound.put((h, p)), **kw)
            except BaseException as e:   # Surface in the test.
                box['error'] = e
                bound.put(None)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        addr = bound.get(timeout=60)
        assert addr is not None, box.get('error')
        return addr[0], addr[1], t, box

    @staticmethod
    def _session(host, port, lines):
        with socket.create_connection((host, port), timeout=60) as c:
            c.sendall(('\n'.join(lines) + '\n').encode())
            c.shutdown(socket.SHUT_WR)
            out = b''
            while True:
                chunk = c.recv(65536)
                if not chunk:
                    break
                out += chunk
        return [json.loads(l) for l in out.decode().splitlines() if l]

    def test_round_trip_matches_serve_lines(self, served):
        path, stream = served
        lines = _lines(stream, frames=400)
        host, port, t, box = self._start(path, max_sessions=1)
        got = self._session(host, port, lines)
        t.join(timeout=60)
        assert not t.is_alive() and box.get('counts') == [len(got)]
        want = serve.serve_lines(path, io.StringIO('\n'.join(lines) + '\n'),
                                 device='cpu')
        assert len(got) == len(want) >= 5
        assert got == [dict(w, latency_ms=g['latency_ms'])
                       for g, w in zip(got, want)]

    def test_round_trip_from_an_artifact(self, served, port_artifact):
        """The listener serves the port's artifact (loaded once) as it
        serves the model directory."""
        path, stream = served
        lines = _lines(stream, frames=400)
        host, port, t, box = self._start(port_artifact, max_sessions=1,
                                         reduction='lda')
        got = self._session(host, port, lines)
        t.join(timeout=60)
        assert not t.is_alive() and box.get('counts') == [len(got)]
        want = serve.serve_lines(path, io.StringIO('\n'.join(lines) + '\n'),
                                 device='cpu')
        assert len(got) == len(want) >= 5
        assert got == [dict(w, latency_ms=g['latency_ms'])
                       for g, w in zip(got, want)]

    def test_sessions_get_fresh_state(self, served):
        path, stream = served
        lines = _lines(stream, step=40, frames=320)
        host, port, t, box = self._start(path, max_sessions=2)
        first = self._session(host, port, lines)
        second = self._session(host, port, lines)
        t.join(timeout=60)
        assert not t.is_alive()
        assert box.get('counts') == [len(first), len(second)]
        assert len(first) >= 1
        assert [d['score1'] for d in first] == [d['score1'] for d in second]

    def test_survives_client_reset(self, served):
        path, stream = served
        host, port, t, box = self._start(path, max_sessions=2)
        s = socket.create_connection((host, port), timeout=60)
        s.sendall(b'not json\n')
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack('ii', 1, 0))
        s.close()
        got = self._session(host, port, _lines(stream, frames=200))
        t.join(timeout=60)
        assert not t.is_alive() and 'error' not in box
        assert len(got) >= 1 and box['counts'][1] == len(got)

    def test_survives_binary_probe(self, served):
        path, stream = served
        host, port, t, box = self._start(path, max_sessions=2)
        with socket.create_connection((host, port), timeout=60) as s:
            s.sendall(b'\x16\x03\x01\x02\x00\xff\xfe binary probe\n')
            s.shutdown(socket.SHUT_WR)
            while s.recv(65536):
                pass
        got = self._session(host, port, _lines(stream, frames=200))
        t.join(timeout=60)
        assert not t.is_alive() and 'error' not in box
        assert box['counts'][0] == -1 and box['counts'][1] == len(got) >= 1

    def test_survives_an_oversized_number(self, served):
        """A line whose number overflows float32 is skipped, the session
        is served to its end, and the listener takes the next one."""
        path, stream = served
        lines = _lines(stream, frames=200)
        host, port, t, box = self._start(path, max_sessions=2)
        first = self._session(host, port, [OVERSIZED] + lines)
        second = self._session(host, port, lines)
        t.join(timeout=60)
        assert not t.is_alive() and 'error' not in box
        assert box['counts'] == [len(first), len(second)]
        assert len(first) >= 1 and _scores(first) == _scores(second)

    def test_failing_launch_ends_the_listener(self, served, monkeypatch):
        """A card failure is not a session's fault: it ends the listener
        with the KernelError, not an aborted session and a next one."""
        path, stream = served
        lines = _lines(stream, frames=200)
        _fail_every_push(monkeypatch, _kernel_fails)
        host, port, t, box = self._start(path, max_sessions=2)
        try:
            got = self._session(host, port, lines)
        except OSError:     # The listener closed with the chunks unread.
            got = []
        assert got == []
        t.join(timeout=60)
        assert not t.is_alive() and 'counts' not in box
        assert isinstance(box['error'], kernels.KernelError)

    def test_idle_timeout_aborts_the_session(self, served):
        path, stream = served
        host, port, t, box = self._start(path, max_sessions=2,
                                         idle_timeout_s=0.5)
        with socket.create_connection((host, port), timeout=60) as idle:
            got = b''
            while True:               # The server gives up and closes.
                chunk = idle.recv(65536)
                if not chunk:
                    break
                got += chunk
        assert got == b''
        served_lines = self._session(host, port, _lines(stream, frames=200))
        t.join(timeout=60)
        assert box['counts'] == [-1, len(served_lines)]

    def test_bad_address_rejected(self):
        for bad in ('tcp://nohost', 'tcp://h:notaport', 'tcp://:-5'):
            with pytest.raises(ValueError):
                serve._parse_tcp(bad)
        assert serve._parse_tcp('tcp://0.0.0.0:7355') == ('0.0.0.0', 7355)
        assert serve._parse_tcp('tcp://[::1]:80') == ('::1', 80)
        assert serve._parse_tcp('tcp://:0') == ('', 0)

    def test_ipv6_listener(self, served):
        if not socket.has_ipv6:
            pytest.skip('platform has no IPv6')
        try:
            probe = socket.socket(socket.AF_INET6, socket.SOCK_STREAM)
            probe.bind(('::1', 0))
            probe.close()
        except OSError:
            pytest.skip('IPv6 loopback unavailable')
        path, stream = served
        host, port, t, box = self._start(path, max_sessions=1,
                                         address='tcp://[::1]:0')
        got = self._session('::1', port, _lines(stream, frames=200))
        t.join(timeout=60)
        assert not t.is_alive() and 'error' not in box
        assert box.get('counts') == [len(got)] and len(got) >= 1
