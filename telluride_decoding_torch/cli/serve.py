"""Real-time streaming attention server (port of cli/serve.py).

Frames arrive in chunks; lag context is carried across chunk boundaries;
each chunk is one ``Decoder.infer_pair`` call, which for a CCA model with
the LDA reduction is one launch of kernel K1 scoring both speakers
against one read of the EEG chunk; window decisions stream out as JSON
lines with per-window latency. The state-space decision rule (``ssd``)
adds one launch of kernel S1 a window on the card.

  python -m telluride_decoding_torch.cli.serve \\
      --serve_model_dir /model --serve_input stream.npz \\
      --chunk_size 32 --serve_window_width 100 --serve_window_step 50

``--serve_input`` is an .npz holding eeg [N, C], audio1 [N, 1] and
audio2 [N, 1] to replay (``--serve_pipeline`` dispatches chunk k+1 before
reading chunk k's scores back); ``-`` reads one JSON chunk per stdin line
({"eeg": [[...]], "audio1": ..., "audio2": ...}); ``tcp://HOST:PORT``
(``tcp://[::1]:PORT`` for IPv6) listens for connections that speak the
same line protocol, decisions returning on the socket, the model loaded
once and sessions served one after another, each with fresh streaming
state. ``--selftest`` serves a toy linear model and checks the decisions
track a planted attention switch. The flags keep the names of the JAX
package's tdt-serve; ``--serve_device`` (default cuda) is new. The
model directory is a native one (model.json), a reference TF SavedModel
(saved_model.pb), migrated on the fly (models/migrate.py) beside its
decoder_model.json, or an AOT artifact of the port (``aot_manifest.json``
beside ``infer_pair.pt2``, written by ``cli.export_aot``), whose exported
program scores each chunk (one K1 launch for a CCA or deep CCA model with
the LDA reduction). An artifact serves with the reduction it was exported
with: an explicit ``--serve_reduction`` that differs is refused, as in
the JAX package. An artifact of the JAX package (a StableHLO program,
``infer_pair.shlo``) cannot run in PyTorch and is refused.
``--trace_dir D`` runs any mode under a torch.profiler trace written to
``D/trace.json``: each push's spans (``serve.push``, the context
buffers, the decoder's copies and launch, the window store and the
decision rule) drawn over K1, S1 and the copies.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from telluride_decoding_torch import kernels
from telluride_decoding_torch.cli.decoding import add_flags
from telluride_decoding_torch.cli.infer import load_model
from telluride_decoding_torch.decide import attention_decoder
from telluride_decoding_torch.decode import aot, infer_decoder
from telluride_decoding_torch.decode.result_store import TwoResultStore
from telluride_decoding_torch.ops.lagstack import LagRows
from telluride_decoding_torch.utils import profiling

REDUCTIONS = ('first', 'second', 'mean', 'mean-squared', 'lda')
DECISIONS = ('wta', 'stepped', 'ssd')
FIELDS = ('eeg', 'audio1', 'audio2')
# A failure of the card or of a kernel is not a bad chunk: every later
# chunk would fail alike, so it ends the session instead of being skipped.
DEVICE_ERRORS = (kernels.KernelError,) + (
    (torch.AcceleratorError,) if hasattr(torch, 'AcceleratorError') else ())


def _load_serving_decoder(model_dir: str, reduction: Optional[str],
                          device):
    """A model directory's decoder, or an AOT artifact's ExportedDecoder.

    ``reduction=None`` means "no explicit request": an artifact serves
    with the reduction baked in at export time, a model directory with
    'lda'. An explicit reduction that conflicts with an artifact's is
    refused rather than silently ignored (JAX cli/serve.py:53-73); an
    artifact of the JAX package is refused (decode/aot.py)."""
    if aot.is_aot_artifact(model_dir):
        decoder = aot.load_exported_decoder(model_dir, device)
        if reduction is not None and reduction != decoder.reduction:
            raise ValueError(
                'AOT artifact %s was exported with reduction %r; '
                'requested %r. Pass --serve_reduction %s (or drop the '
                'flag), or re-export the artifact.'
                % (model_dir, decoder.reduction, reduction,
                   decoder.reduction))
        return decoder
    return load_model(model_dir, 'lda' if reduction is None else reduction,
                      device)


class ContextBuffer:
    """Carries lag-window context across streaming chunk boundaries.

    Emits output frame t once frames up to t+post have arrived; frame
    t's row is [x[t-pre], ..., x[t+post]] with zeros only before the
    stream start, identical to the offline per-file lag stack. At stream
    end the final ``post`` frames are never emitted: a real-time server
    has no future frames to complete them with.
    """

    def __init__(self, channels: int, pre: int, post: int):
        self._pre = pre
        self._post = post
        # Frames from stream index emitted - pre on (zeros before 0).
        self._buf = np.zeros((pre, channels), np.float32)
        self._arrived = 0
        self._emitted = 0

    def push(self, frames: np.ndarray) -> LagRows:
        """Adds [n, C] frames; returns all newly-completable stacked
        rows [m, (pre+1+post)*C] (possibly none) as their raw window."""
        frames = np.atleast_2d(np.asarray(frames, np.float32))
        self._buf = np.concatenate([self._buf, frames], axis=0)
        self._arrived += frames.shape[0]
        avail = self._arrived - self._post - self._emitted
        if avail <= 0:
            return LagRows.empty(frames.shape[1], self._pre, self._post)
        # The buffer holds avail + pre + post frames. A guard for one
        # whose state was moved out of step and holds fewer: its rows are
        # those the host stack gave it, the rows of the frames held with
        # zeros after them (lag_stack_np's edge), no more than it holds.
        rows = min(avail, max(self._buf.shape[0] - self._pre, 0))
        window = self._buf[:rows + self._pre + self._post]
        short = rows + self._pre + self._post - window.shape[0]
        if short > 0:
            window = np.concatenate(
                [window, np.zeros((short, window.shape[1]), np.float32)])
        out = LagRows(window, self._pre, self._post)
        self._buf = self._buf[avail:]
        self._emitted += avail
        return out

    @property
    def delay_frames(self) -> int:
        return self._post


class StreamingAttentionServer:
    """Chunked two-speaker decode + windowed attention decisions.

    With ``pipeline`` a push dispatches its chunk (``infer_pair_async``)
    and harvests the previous push's scores, so the card's work and the
    copies back overlap the next chunk's host work; decisions come one
    push later (``flush()`` at stream end) with the same values."""

    def __init__(self, decoder: infer_decoder.Decoder, eeg_channels: int,
                 audio_channels: int = 1, window_width: int = 100,
                 window_step: int = 50, decision: str = 'wta',
                 frame_rate: float = 100.0, pipeline: bool = False):
        self._decoder = decoder
        self._pipeline = pipeline
        self._inflight = None
        self.audio_channels = audio_channels
        self.eeg_channels = eeg_channels
        params = decoder.decoding_model_params
        eeg_pre = int(params.get('pre_context', 0))
        eeg_post = int(params.get('post_context', 0))
        in2_pre = int(params.get('input2_pre_context', 0))
        in2_post = int(params.get('input2_post_context', 0))
        self._ctx_eeg = ContextBuffer(eeg_channels, eeg_pre, eeg_post)
        self._ctx_a1 = ContextBuffer(audio_channels, in2_pre, in2_post)
        self._ctx_a2 = ContextBuffer(audio_channels, in2_pre, in2_post)
        # Completed rows queue per stream, as raw windows, until every
        # stream has caught up: the buffers complete rows at different
        # rates when the eeg and audio post-contexts differ.
        self._pend_eeg = LagRows.empty(eeg_channels, eeg_pre, eeg_post)
        self._pend_a1 = LagRows.empty(audio_channels, in2_pre, in2_post)
        self._pend_a2 = LagRows.empty(audio_channels, in2_pre, in2_post)
        # Raw audio for the `output` stream, kept aligned with the eeg
        # emission delay.
        self._q1 = np.zeros((0, audio_channels), np.float32)
        self._q2 = np.zeros((0, audio_channels), np.float32)
        self._store = TwoResultStore(window_width=window_width,
                                     window_step=window_step)
        self._decide = attention_decoder.create_attention_decoder(
            decision, window_step=window_step, frame_rate=frame_rate,
            device=decoder.device)
        self._window_width = window_width
        self._window_step = window_step
        self._frame_rate = frame_rate
        self._windows_emitted = 0
        self._pushes = 0

    def push(self, eeg: np.ndarray, audio1: np.ndarray,
             audio2: np.ndarray) -> List[Dict]:
        """Feeds one acquisition chunk; returns completed decisions.

        The three fields must carry the same frame count: a ragged chunk
        would skew every later window, so it raises before buffering."""
        t0 = time.perf_counter()
        request, self._pushes = self._pushes, self._pushes + 1
        with profiling.span('serve.push', request):
            with profiling.span('serve.context'):
                rows = self._context_rows(eeg, audio1, audio2)
            prev, self._inflight = self._inflight, None
            if rows is not None:
                if self._pipeline:
                    self._inflight = (self._decoder.infer_pair_async(*rows),
                                      t0)
                else:
                    prev = (self._decoder.infer_pair(*rows), t0)
            return self._harvest(prev, t0)

    def _context_rows(self, eeg, audio1, audio2) -> Optional[tuple]:
        """The chunk through the context buffers and queues: the rows
        every stream has completed, as infer_pair's (stacked eeg, two
        stacked audio, two raw audio), or None. The stacked rows are
        LagRows: raw windows the decoder stacks where it uses them."""
        eeg = np.atleast_2d(np.asarray(eeg, np.float32))
        audio1 = np.atleast_2d(np.asarray(audio1, np.float32))
        audio2 = np.atleast_2d(np.asarray(audio2, np.float32))
        if not eeg.shape[0] == audio1.shape[0] == audio2.shape[0]:
            raise ValueError(
                'push: eeg/audio1/audio2 chunks must carry the same frame '
                'count, got %d/%d/%d.'
                % (eeg.shape[0], audio1.shape[0], audio2.shape[0]))
        self._pend_eeg = self._pend_eeg.join(self._ctx_eeg.push(eeg))
        self._pend_a1 = self._pend_a1.join(self._ctx_a1.push(audio1))
        self._pend_a2 = self._pend_a2.join(self._ctx_a2.push(audio2))
        self._q1 = np.concatenate([self._q1, audio1])
        self._q2 = np.concatenate([self._q2, audio2])
        n = min(len(self._pend_eeg), len(self._pend_a1),
                len(self._pend_a2), self._q1.shape[0], self._q2.shape[0])
        if not n:
            return None
        stacked, self._pend_eeg = self._pend_eeg.split(n)
        a1_ctx, self._pend_a1 = self._pend_a1.split(n)
        a2_ctx, self._pend_a2 = self._pend_a2.split(n)
        y1, self._q1 = self._q1[:n], self._q1[n:]
        y2, self._q2 = self._q2[:n], self._q2[n:]
        return stacked, a1_ctx, a2_ctx, y1, y2

    def flush(self) -> List[Dict]:
        """Harvests the chunk still in flight at stream end (the
        pipelined mode reads each chunk back one push later)."""
        prev, self._inflight = self._inflight, None
        return self._harvest(prev, time.perf_counter())

    def _harvest(self, prev, t0: float) -> List[Dict]:
        if prev is not None:
            (s1, s2), t0 = prev
            # Pipelined: waits for the chunk's copies (decoder.copy_out).
            s1, s2 = np.asarray(s1), np.asarray(s2)
        with profiling.span('serve.store'):
            if prev is not None:
                self._store.add_data(s1.reshape(-1, 1), s2.reshape(-1, 1))
            # Latency counts from the push that dispatched the windows'
            # chunk.
            return self._drain(t0)

    def _drain(self, t0: float) -> List[Dict]:
        decisions = []
        for w1, w2 in self._store.next_window():
            c1 = float(np.mean(w1))
            c2 = float(np.mean(w2))
            with profiling.span('decide.window'):
                att = self._decide.attention(c1, c2)
            center = (self._windows_emitted * self._window_step +
                      self._window_width / 2.0)
            decisions.append({
                'window': self._windows_emitted,
                'time_s': round(center / self._frame_rate, 4),
                'score1': round(c1, 6),
                'score2': round(c2, 6),
                # A probability for ssd, a boolean for wta and stepped.
                'attend_speaker1': bool(att[0] >= 0.5),
                'latency_ms': round((time.perf_counter() - t0) * 1e3, 3),
            })
            self._windows_emitted += 1
        return decisions


def _write(out_stream, record: Dict):
    if out_stream is not None:
        out_stream.write(json.dumps(record) + '\n')


def serve_stream(model_dir: str, eeg: np.ndarray, audio1: np.ndarray,
                 audio2: np.ndarray, *, device, chunk_size: int = 32,
                 reduction: Optional[str] = None, decision: str = 'wta',
                 window_width: int = 100, window_step: int = 50,
                 frame_rate: float = 100.0, out_stream=None,
                 pipeline: bool = False) -> List[Dict]:
    """Replays a recorded stream through the server; returns decisions
    and, with an out_stream, writes them plus a latency summary line."""
    decoder = _load_serving_decoder(model_dir, reduction, device)

    def orient(a):
        a = np.atleast_2d(np.asarray(a, np.float32))
        return a.T if a.shape[0] == 1 else a
    audio1 = orient(audio1)
    audio2 = orient(audio2)
    server = StreamingAttentionServer(
        decoder, eeg_channels=eeg.shape[1], audio_channels=audio1.shape[1],
        window_width=window_width, window_step=window_step,
        decision=decision, frame_rate=frame_rate, pipeline=pipeline)
    all_decisions = []

    def emit(records):
        for record in records:
            all_decisions.append(record)
            _write(out_stream, record)
    for start in range(0, eeg.shape[0], chunk_size):
        sl = slice(start, start + chunk_size)
        emit(server.push(eeg[sl], audio1[sl], audio2[sl]))
    emit(server.flush())
    if all_decisions:
        lat = np.asarray([d['latency_ms'] for d in all_decisions])
        _write(out_stream, {
            'summary': True, 'windows': len(all_decisions),
            'latency_p50_ms': round(float(np.percentile(lat, 50)), 3),
            'latency_p95_ms': round(float(np.percentile(lat, 95)), 3),
        })
    return all_decisions


def _orient_chunk(a, frames: int, known_channels: Optional[int]
                  ) -> np.ndarray:
    """[frames, channels] from a JSON field: a flat list is mono frames;
    a 2-D field is transposed when only its transpose fits."""
    a = np.asarray(a, np.float32)
    if a.ndim <= 1:
        a = a.reshape(-1, 1)
    elif known_channels is not None:
        if a.shape[1] != known_channels and a.shape[0] == known_channels:
            a = a.T
    elif a.shape[0] != frames and a.shape[1] == frames:
        a = a.T
    if known_channels is not None and a.shape[1] != known_channels:
        raise ValueError('field shape %s does not match the established '
                         '%d channel(s)' % (a.shape, known_channels))
    return a


def _is_keepalive(chunk) -> bool:
    """A chunk whose three fields are all present and empty lists. A
    chunk missing a field (a misspelled key, say) or with a null field is
    not one: it is a bad line and is reported."""
    return isinstance(chunk, dict) and all(
        isinstance(chunk.get(key), list) and
        np.asarray(chunk[key]).size == 0 for key in FIELDS)


def _chunk_fields(chunk) -> tuple:
    """The three fields of a parsed chunk; a missing or null field
    raises (np.asarray(None) would be one NaN frame)."""
    fields = tuple(chunk[key] for key in FIELDS)
    for key, value in zip(FIELDS, fields):
        if value is None:
            raise ValueError('field %r is null' % key)
    return fields


def serve_lines(model_dir: str, in_stream, *, device,
                reduction: Optional[str] = None, decision: str = 'wta',
                window_width: int = 100, window_step: int = 50,
                frame_rate: float = 100.0, out_stream=None,
                decoder=None) -> List[Dict]:
    """Line protocol: one JSON chunk per input line, decisions out as
    JSON lines flushed per chunk. A bad line or chunk is reported on
    stderr and skipped; EOF ends the stream, and a failure of the card or
    a kernel (DEVICE_ERRORS) raises. ``decoder`` skips the model
    load (the TCP listener loads once); the streaming state is this
    call's own. Live serving stays chunk-synchronous: pipelining would
    hold each chunk's decisions until the next chunk arrives."""
    if decoder is None:
        decoder = _load_serving_decoder(model_dir, reduction, device)
    server = None
    decisions: List[Dict] = []
    for line in in_stream:
        line = line.strip()
        if not line:
            continue
        try:
            chunk = json.loads(line)
            if _is_keepalive(chunk):
                continue
            eeg, audio1, audio2 = _chunk_fields(chunk)
            eeg = _orient_chunk(
                eeg, -1, None if server is None else server.eeg_channels)
            known = None if server is None else server.audio_channels
            a1 = _orient_chunk(audio1, eeg.shape[0], known)
            a2 = _orient_chunk(audio2, eeg.shape[0], known)
        except Exception as error:
            # Any parse error (an int too large for float32 raises
            # OverflowError) skips the line, as in the JAX server.
            print('serve: skipping bad input line (%r): %.80s' %
                  (error, line), file=sys.stderr)
            continue
        if server is None:
            if eeg.shape[0] == 0:
                continue
            server = StreamingAttentionServer(
                decoder, eeg_channels=eeg.shape[1],
                audio_channels=a1.shape[1], window_width=window_width,
                window_step=window_step, decision=decision,
                frame_rate=frame_rate)
        try:
            records = server.push(eeg, a1, a2)
        except DEVICE_ERRORS:
            raise
        except Exception as error:
            print('serve: skipping bad chunk (%s): %.80s' % (error, line),
                  file=sys.stderr)
            continue
        for record in records:
            decisions.append(record)
            _write(out_stream, record)
        if out_stream is not None:
            out_stream.flush()
    return decisions


def _parse_tcp(address: str) -> tuple:
    """'tcp://HOST:PORT' -> (host, port); a bracketed IPv6 literal loses
    its brackets. An empty host binds all interfaces; port 0 asks the OS
    for a free one."""
    host, sep, port = address[len('tcp://'):].rpartition(':')
    if not sep or not port.isdigit():
        raise ValueError('serve: bad TCP address %r (want tcp://HOST:PORT, '
                         'e.g. tcp://0.0.0.0:7355)' % address)
    if host.startswith('[') and host.endswith(']'):
        host = host[1:-1]
    return host, int(port)


def serve_socket(model_dir: str, address: str, *, device,
                 reduction: Optional[str] = None, decision: str = 'wta',
                 window_width: int = 100, window_step: int = 50,
                 frame_rate: float = 100.0,
                 max_sessions: Optional[int] = None,
                 idle_timeout_s: float = 0.0,
                 on_bound=None) -> List[int]:
    """TCP listener speaking the line protocol over each connection.

    The model loads once; connections are accepted one after another,
    each served by serve_lines with fresh streaming state, decisions
    returning on the same socket. A client half-close ends its session;
    a reset, a timeout (``idle_timeout_s`` > 0 with no data, or a dead
    peer found by TCP keepalive) or bytes that are not UTF-8 abort only
    that session; a failure of the card or a kernel ends the listener.
    ``max_sessions`` bounds the sessions served (None: forever);
    ``on_bound(host, port)`` reports the bound address.
    Returns the decisions per session (-1 for an aborted one)."""
    import socket
    host, port = _parse_tcp(address)
    decoder = _load_serving_decoder(model_dir, reduction, device)
    family = socket.AF_INET6 if ':' in host else socket.AF_INET
    srv = socket.create_server((host, port), family=family)
    try:
        bound_host, bound_port = srv.getsockname()[:2]
        print('serve: listening on %s:%d' % (bound_host, bound_port),
              file=sys.stderr)
        if on_bound is not None:
            on_bound(bound_host, bound_port)
        counts: List[int] = []
        while max_sessions is None or len(counts) < max_sessions:
            conn, peer = srv.accept()
            print('serve: session %d from %s:%d' %
                  (len(counts), peer[0], peer[1]), file=sys.stderr)
            try:
                with conn:
                    conn.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE,
                                    1)
                    if idle_timeout_s > 0:
                        conn.settimeout(idle_timeout_s)
                    reader = conn.makefile('r', encoding='utf-8',
                                           newline='\n')
                    writer = conn.makefile('w', encoding='utf-8',
                                           newline='\n')
                    try:
                        decisions = serve_lines(
                            model_dir, reader, device=device,
                            decision=decision, window_width=window_width,
                            window_step=window_step, frame_rate=frame_rate,
                            out_stream=writer, decoder=decoder)
                    finally:
                        # Both file objects hold the socket open: close
                        # them so conn's close sends FIN.
                        for f in (writer, reader):
                            try:
                                f.close()
                            except OSError:
                                pass
                    counts.append(len(decisions))
            except (OSError, UnicodeDecodeError) as error:
                print('serve: session %d aborted (%s)' %
                      (len(counts), error), file=sys.stderr)
                counts.append(-1)
        return counts
    finally:
        srv.close()


def _selftest(out_stream, device) -> float:
    """Toy linear model end to end: decisions must track the planted
    attention switch in more than 0.9 of the windows (JAX
    telluride_decoding_tpu/cli/serve.py:641-685)."""
    import tempfile
    from telluride_decoding_torch.data.brain_data import TestBrainData
    from telluride_decoding_torch.models.brain_model import (
        BrainModelLinearRegression)

    rng = np.random.RandomState(42)
    n = 6000
    a1 = np.abs(rng.randn(n, 1)).astype(np.float32)
    a2 = np.abs(rng.randn(n, 1)).astype(np.float32)
    attend = (np.arange(n) >= n // 2)           # Switch at midpoint.
    attended = np.where(attend[:, None], a2, a1)
    eeg = (attended * 2.0 - 1.0 +
           0.05 * rng.randn(n, 1)).astype(np.float32)

    model = BrainModelLinearRegression(input_width=1, output_width=1,
                                       regularization_lambda=1e-4,
                                       device=device)
    bd = TestBrainData('input_1', 'output', 100.0, device=device)
    bd.preserve_test_data(eeg[:n // 2], a1[:n // 2])
    model.fit(bd.create_dataset('train'))
    model.add_metadata({'pre_context': 0, 'post_context': 0,
                        'input2_pre_context': 0, 'input2_post_context': 0,
                        'dnn_regressor': 'linear'}, dataset=None)
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        dec = infer_decoder.create_decoder(tmp, reduction='first',
                                           device=device)
        dec.load_decoding_model(tmp)
        dec.add_data_correlator(a1[:n // 2], a1[:n // 2])
        dec.save_parameters(os.path.join(tmp, 'decoder_model.json'))
        decisions = serve_stream(tmp, eeg, a1, a2, device=device,
                                 chunk_size=64, reduction='first',
                                 decision='wta', window_width=100,
                                 window_step=100, out_stream=out_stream)
    correct = sum(d['attend_speaker1'] != (d['time_s'] >= (n // 2) / 100.0)
                  for d in decisions)
    frac = correct / max(len(decisions), 1)
    print('selftest: %d windows, %.1f%% correct' %
          (len(decisions), 100 * frac), file=sys.stderr)
    if frac <= 0.9:
        raise SystemExit('selftest FAILED: %.3f <= 0.9' % frac)
    return frac


_FLAGS = [
    ('serve_model_dir', str, None, None,
     'Trained model dir (model.json + weights.npz + decoder_model.json), '
     'or an AOT artifact dir of cli.export_aot (aot_manifest.json).'),
    ('serve_input', str, None, None,
     '.npz with eeg/audio1/audio2 arrays to replay, "-" to read JSON '
     'chunk lines from stdin, or "tcp://HOST:PORT" to listen for '
     'connections speaking the same line protocol (decisions return on '
     'the socket; --serve_output is ignored).'),
    ('serve_output', str, None, None,
     'Where to write JSON-line decisions (default stdout).'),
    ('chunk_size', int, 32, None,
     'Frames per push (simulated acquisition chunk).'),
    ('serve_window_width', int, 100, None, 'Frames per correlation window.'),
    ('serve_window_step', int, 50, None, 'Frames between window starts.'),
    # None: not given, which means lda (only an explicit value counts as
    # a request).
    ('serve_reduction', str, None, REDUCTIONS,
     'Correlation-to-scalar reduction (default lda).'),
    ('serve_decoder', str, 'wta', DECISIONS, 'Attention decision rule.'),
    ('serve_frame_rate', float, 100.0, None, 'Frames per second.'),
    ('serve_pipeline', bool, False, None,
     'Replay only: dispatch chunk k+1 before reading chunk k\'s scores '
     'back (infer_pair_async).'),
    ('selftest', bool, False, None,
     'Build a toy model + stream and check the served decisions track the '
     'planted attention switch.'),
    ('serve_idle_timeout_s', float, 0.0, None,
     'TCP mode: abort a session when no data arrives for this many '
     'seconds (0 = wait forever). TCP keepalive is on for every session.'),
    ('serve_device', str, 'cuda', None,
     'torch device to decode on (cuda, or cpu for the plain versions of '
     'the kernels).'),
    ('trace_dir', str, None, None,
     'Write a torch.profiler trace of the experiment here '
     '(trace.json).'),
]


def parse_args(argv: Optional[List[str]]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog='python -m telluride_decoding_torch.cli.serve',
        description='Streaming attention server on the GPU.',
        allow_abbrev=False)
    add_flags(parser, _FLAGS)
    args = parser.parse_args(argv)
    if not args.selftest and not (args.serve_model_dir and args.serve_input):
        parser.error('Need --serve_model_dir and --serve_input (or '
                     '--selftest).')
    if (not args.selftest and args.serve_input.startswith('tcp://')):
        try:
            _parse_tcp(args.serve_input)
        except ValueError as error:
            parser.error(str(error))
    return args


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    with profiling.trace(args.trace_dir, cuda=torch.device(
            args.serve_device).type == 'cuda'):
        return _serve(args)


def _serve(args: argparse.Namespace) -> int:
    tcp_mode = (not args.selftest and args.serve_input.startswith('tcp://'))
    common = dict(device=args.serve_device, reduction=args.serve_reduction,
                  decision=args.serve_decoder,
                  window_width=args.serve_window_width,
                  window_step=args.serve_window_step,
                  frame_rate=args.serve_frame_rate)
    if tcp_mode:
        # Decisions return on each session's socket; --serve_output is
        # never opened, so an existing file there stays as it was.
        if args.serve_output:
            print('serve: --serve_output is ignored in TCP mode (decisions '
                  'return on each session socket)', file=sys.stderr)
        serve_socket(args.serve_model_dir, args.serve_input,
                     idle_timeout_s=args.serve_idle_timeout_s, **common)
        return 0
    out = open(args.serve_output, 'w') if args.serve_output else sys.stdout
    try:
        if args.selftest:
            _selftest(out, args.serve_device)
        elif args.serve_input == '-':
            serve_lines(args.serve_model_dir, sys.stdin, out_stream=out,
                        **common)
        else:
            with np.load(args.serve_input) as data:
                serve_stream(args.serve_model_dir, data['eeg'],
                             data['audio1'], data['audio2'],
                             chunk_size=args.chunk_size, out_stream=out,
                             pipeline=args.serve_pipeline, **common)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def app_main():
    sys.exit(main())


if __name__ == '__main__':
    app_main()
