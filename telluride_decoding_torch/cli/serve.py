"""Real-time streaming attention server (port of cli/serve.py).

Frames arrive in chunks (replayed from an .npz, or JSON lines on stdin);
lag context is carried across chunk boundaries; each chunk is one
``Decoder.infer_pair`` call, which for a CCA model with the LDA reduction
is one launch of kernel K1 scoring both speakers against one read of the
EEG chunk; window decisions stream out as JSON lines with per-window
latency. Chunk-synchronous: a chunk's decisions are out before the next
chunk is read.

  python -m telluride_decoding_torch.cli.serve \\
      --serve_model_dir /model --serve_input stream.npz \\
      --chunk_size 32 --serve_window_width 100 --serve_window_step 50

stream.npz holds eeg [N, C], audio1 [N, 1] and audio2 [N, 1].
``--serve_input -`` reads one JSON chunk per stdin line
({"eeg": [[...]], "audio1": ..., "audio2": ...}). The flags keep the
names of the JAX package's tdt-serve; ``--serve_device`` (default cuda)
is new. TCP mode, --selftest and AOT artifacts are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from telluride_decoding_torch.decide import attention_decoder
from telluride_decoding_torch.decode import infer_decoder
from telluride_decoding_torch.decode.result_store import TwoResultStore
from telluride_decoding_torch.ops.lagstack import lag_stack_np

REDUCTIONS = ('first', 'second', 'mean', 'mean-squared', 'lda')
DECISIONS = ('wta', 'stepped')


def load_model(model_dir: str, reduction: str,
               device) -> infer_decoder.Decoder:
    """Loads the saved model + decoder params from a model directory
    (the counterpart of telluride_decoding_tpu/cli/infer.py:166-177)."""
    decoder = infer_decoder.create_decoder(model_dir, reduction=reduction,
                                           device=device)
    decoder.load_decoding_model(model_dir)
    param_filename = os.path.join(model_dir, 'decoder_model.json')
    if not os.path.exists(param_filename):
        raise IOError('Can not load decoder model parameters from %s' %
                      param_filename)
    decoder.restore_parameters(param_filename)
    return decoder


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

    def push(self, frames: np.ndarray) -> np.ndarray:
        """Adds [n, C] frames; returns all newly-completable stacked
        rows [m, (pre+1+post)*C] (possibly empty)."""
        frames = np.atleast_2d(np.asarray(frames, np.float32))
        self._buf = np.concatenate([self._buf, frames], axis=0)
        self._arrived += frames.shape[0]
        avail = self._arrived - self._post - self._emitted
        if avail <= 0:
            return np.zeros(
                (0, (self._pre + 1 + self._post) * frames.shape[1]),
                np.float32)
        rows = self._buf[:avail + self._pre + self._post]
        out = lag_stack_np(rows, self._pre, self._post)[
            self._pre:self._pre + avail]
        self._buf = self._buf[avail:]
        self._emitted += avail
        return out

    @property
    def delay_frames(self) -> int:
        return self._post


class StreamingAttentionServer:
    """Chunked two-speaker decode + windowed attention decisions."""

    def __init__(self, decoder: infer_decoder.Decoder, eeg_channels: int,
                 audio_channels: int = 1, window_width: int = 100,
                 window_step: int = 50, decision: str = 'wta',
                 frame_rate: float = 100.0):
        self._decoder = decoder
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
        # Completed rows queue per stream until every stream has caught
        # up: the buffers complete rows at different rates when the eeg
        # and audio post-contexts differ.
        self._pend_eeg = np.zeros(
            (0, (eeg_pre + 1 + eeg_post) * eeg_channels), np.float32)
        in2_width = (in2_pre + 1 + in2_post) * audio_channels
        self._pend_a1 = np.zeros((0, in2_width), np.float32)
        self._pend_a2 = np.zeros((0, in2_width), np.float32)
        # Raw audio for the `output` stream, kept aligned with the eeg
        # emission delay.
        self._q1 = np.zeros((0, audio_channels), np.float32)
        self._q2 = np.zeros((0, audio_channels), np.float32)
        self._store = TwoResultStore(window_width=window_width,
                                     window_step=window_step)
        self._decide = attention_decoder.create_attention_decoder(decision)
        self._window_width = window_width
        self._window_step = window_step
        self._frame_rate = frame_rate
        self._windows_emitted = 0

    def push(self, eeg: np.ndarray, audio1: np.ndarray,
             audio2: np.ndarray) -> List[Dict]:
        """Feeds one acquisition chunk; returns completed decisions.

        The three fields must carry the same frame count: a ragged chunk
        would skew every later window, so it raises before buffering."""
        t0 = time.perf_counter()
        eeg = np.atleast_2d(np.asarray(eeg, np.float32))
        audio1 = np.atleast_2d(np.asarray(audio1, np.float32))
        audio2 = np.atleast_2d(np.asarray(audio2, np.float32))
        if not eeg.shape[0] == audio1.shape[0] == audio2.shape[0]:
            raise ValueError(
                'push: eeg/audio1/audio2 chunks must carry the same frame '
                'count, got %d/%d/%d.'
                % (eeg.shape[0], audio1.shape[0], audio2.shape[0]))
        self._pend_eeg = np.concatenate(
            [self._pend_eeg, self._ctx_eeg.push(eeg)])
        self._pend_a1 = np.concatenate(
            [self._pend_a1, self._ctx_a1.push(audio1)])
        self._pend_a2 = np.concatenate(
            [self._pend_a2, self._ctx_a2.push(audio2)])
        self._q1 = np.concatenate([self._q1, audio1])
        self._q2 = np.concatenate([self._q2, audio2])
        n = min(self._pend_eeg.shape[0], self._pend_a1.shape[0],
                self._pend_a2.shape[0], self._q1.shape[0],
                self._q2.shape[0])
        if n:
            stacked, self._pend_eeg = (self._pend_eeg[:n],
                                       self._pend_eeg[n:])
            a1_ctx, self._pend_a1 = self._pend_a1[:n], self._pend_a1[n:]
            a2_ctx, self._pend_a2 = self._pend_a2[:n], self._pend_a2[n:]
            y1, self._q1 = self._q1[:n], self._q1[n:]
            y2, self._q2 = self._q2[:n], self._q2[n:]
            s1, s2 = self._decoder.infer_pair(stacked, a1_ctx, a2_ctx, y1,
                                              y2)
            self._store.add_data(np.asarray(s1).reshape(-1, 1),
                                 np.asarray(s2).reshape(-1, 1))
        return self._drain(t0)

    def _drain(self, t0: float) -> List[Dict]:
        decisions = []
        for w1, w2 in self._store.next_window():
            c1 = float(np.mean(w1))
            c2 = float(np.mean(w2))
            att = self._decide.attention(c1, c2)
            center = (self._windows_emitted * self._window_step +
                      self._window_width / 2.0)
            decisions.append({
                'window': self._windows_emitted,
                'time_s': round(center / self._frame_rate, 4),
                'score1': round(c1, 6),
                'score2': round(c2, 6),
                'attend_speaker1': bool(att[0]),
                'latency_ms': round((time.perf_counter() - t0) * 1e3, 3),
            })
            self._windows_emitted += 1
        return decisions


def _write(out_stream, record: Dict):
    if out_stream is not None:
        out_stream.write(json.dumps(record) + '\n')


def serve_stream(model_dir: str, eeg: np.ndarray, audio1: np.ndarray,
                 audio2: np.ndarray, *, device, chunk_size: int = 32,
                 reduction: str = 'lda', decision: str = 'wta',
                 window_width: int = 100, window_step: int = 50,
                 frame_rate: float = 100.0, out_stream=None) -> List[Dict]:
    """Replays a recorded stream through the server; returns decisions
    and, with an out_stream, writes them plus a latency summary line."""
    decoder = load_model(model_dir, reduction, device)

    def orient(a):
        a = np.atleast_2d(np.asarray(a, np.float32))
        return a.T if a.shape[0] == 1 else a
    audio1 = orient(audio1)
    audio2 = orient(audio2)
    server = StreamingAttentionServer(
        decoder, eeg_channels=eeg.shape[1], audio_channels=audio1.shape[1],
        window_width=window_width, window_step=window_step,
        decision=decision, frame_rate=frame_rate)
    all_decisions = []
    for start in range(0, eeg.shape[0], chunk_size):
        sl = slice(start, start + chunk_size)
        for record in server.push(eeg[sl], audio1[sl], audio2[sl]):
            all_decisions.append(record)
            _write(out_stream, record)
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


def serve_lines(model_dir: str, in_stream, *, device,
                reduction: str = 'lda', decision: str = 'wta',
                window_width: int = 100, window_step: int = 50,
                frame_rate: float = 100.0, out_stream=None) -> List[Dict]:
    """Line protocol: one JSON chunk per input line, decisions out as
    JSON lines flushed per chunk. A bad line or chunk is reported on
    stderr and skipped; EOF ends the stream."""
    decoder = load_model(model_dir, reduction, device)
    server = None
    decisions: List[Dict] = []
    for line in in_stream:
        line = line.strip()
        if not line:
            continue
        try:
            chunk = json.loads(line)
            if not (chunk.get('eeg') or chunk.get('audio1') or
                    chunk.get('audio2')):
                continue        # Empty keepalive chunk.
            eeg = _orient_chunk(
                chunk['eeg'], -1,
                None if server is None else server.eeg_channels)
            known = None if server is None else server.audio_channels
            a1 = _orient_chunk(chunk['audio1'], eeg.shape[0], known)
            a2 = _orient_chunk(chunk['audio2'], eeg.shape[0], known)
        except (ValueError, KeyError, TypeError, AttributeError) as error:
            print('serve: skipping bad input line (%s): %.80s' %
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
        except ValueError as error:
            print('serve: skipping bad chunk (%s): %.80s' % (error, line),
                  file=sys.stderr)
            continue
        for record in records:
            decisions.append(record)
            _write(out_stream, record)
        if out_stream is not None:
            out_stream.flush()
    return decisions


def parse_args(argv: Optional[List[str]]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog='python -m telluride_decoding_torch.cli.serve',
        description='Streaming attention server on the GPU.')
    parser.add_argument('--serve_model_dir', required=True,
                        help='Trained model dir (model.json + weights.npz '
                        '+ decoder_model.json).')
    parser.add_argument('--serve_input', required=True,
                        help='.npz with eeg/audio1/audio2 arrays to replay, '
                        'or "-" to read JSON chunk lines from stdin.')
    parser.add_argument('--serve_output', default=None,
                        help='Where to write JSON-line decisions (default '
                        'stdout).')
    parser.add_argument('--chunk_size', type=int, default=32,
                        help='Frames per push (simulated acquisition '
                        'chunk).')
    parser.add_argument('--serve_window_width', type=int, default=100,
                        help='Frames per correlation window.')
    parser.add_argument('--serve_window_step', type=int, default=50,
                        help='Frames between window starts.')
    parser.add_argument('--serve_reduction', default='lda',
                        choices=REDUCTIONS,
                        help='Correlation-to-scalar reduction.')
    parser.add_argument('--serve_decoder', default='wta', choices=DECISIONS,
                        help='Attention decision rule.')
    parser.add_argument('--serve_frame_rate', type=float, default=100.0,
                        help='Frames per second.')
    parser.add_argument('--serve_device', default='cuda',
                        help='torch device to decode on (cuda, or cpu for '
                        'the plain versions of the kernels).')
    args = parser.parse_args(argv)
    if args.serve_input.startswith('tcp://'):
        parser.error('TCP serving is not ported to telluride_decoding_torch '
                     'yet.')
    return args


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    out = open(args.serve_output, 'w') if args.serve_output else sys.stdout
    try:
        common = dict(device=args.serve_device,
                      reduction=args.serve_reduction,
                      decision=args.serve_decoder,
                      window_width=args.serve_window_width,
                      window_step=args.serve_window_step,
                      frame_rate=args.serve_frame_rate, out_stream=out)
        if args.serve_input == '-':
            serve_lines(args.serve_model_dir, sys.stdin, **common)
        else:
            with np.load(args.serve_input) as data:
                serve_stream(args.serve_model_dir, data['eeg'],
                             data['audio1'], data['audio2'],
                             chunk_size=args.chunk_size, **common)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
