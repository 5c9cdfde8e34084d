"""Serving cells: one two-talker session pushed chunk by chunk through
``cli/serve.py::StreamingAttentionServer.push`` in a closed loop.

Set-up draws the decoder's weights and the session from the seed, writes
the weights through ``BrainModelCCA.save`` and ``save_parameters`` to a
model directory under TMPDIR, loads it as ``cli/serve.py`` does, and
pushes the session's first chunks (every shape the window will see, the
kernel library's load, S1's launcher). The window then pushes the
session's next chunks, looping the session end to end where the window
outlasts it, and times each push on the host clock.

The benchmark's own wrappers around the server's ``infer_pair`` and
``attention`` give the decoder's and the decision rule's host spans and
keep every window's two means and decision; for the state-space rule the
decoder's state is copied before a few windows drawn from the seed.
After the window, ``reference/`` recomputes every window's means (and
decisions) from the session and the weights.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench.harness import common, gen, trace
from portbench.reference import decode as ref_decode
from portbench.reference import ssd as ref_ssd


def write_model(weights: dict, cfg: dict, model_dir: str) -> None:
    """The decoder as a model directory: model.json and weights.npz
    (BrainModelCCA.save) and decoder_model.json (save_parameters)."""
    from telluride_decoding_torch.decode.infer_decoder import (
        CCADecoder, CorrelationParamsTuple, ModelParamsTuple)
    from telluride_decoding_torch.models.cca import BrainModelCCA
    from telluride_decoding_torch.solvers.lda import LdaParams
    model = BrainModelCCA.from_numpy(
        {k: weights[k] for k in ('mean1', 'mean2', 'rot1', 'rot2')}, 'cpu')
    model.add_metadata({'pre_context': cfg['eeg_pre'],
                        'post_context': cfg['eeg_post'],
                        'input2_pre_context': cfg['audio_pre'],
                        'input2_post_context': cfg['audio_post'],
                        'dnn_regressor': 'cca'})
    model.save(model_dir)
    dims = cfg['cca_dims']
    decoder = CCADecoder(model, reduction=cfg['reduction'], device='cpu')
    decoder.model_params = ModelParamsTuple(
        CorrelationParamsTuple(1, np.zeros(dims), np.zeros(dims),
                               np.zeros(dims), np.zeros(dims),
                               weights['corr_mean_x'],
                               weights['corr_mean_y'],
                               weights['corr_power']),
        LdaParams(weights['lda_w'], np.zeros_like(weights['lda_w']),
                  np.array([0, 1]), np.zeros((2, dims)),
                  weights['lda_slope'], weights['lda_intercept']))
    decoder.save_parameters(os.path.join(model_dir, 'decoder_model.json'))


class Taps:
    """The benchmark's wrappers on one server: host spans of the
    decoder's ``infer_pair`` and the rule's ``attention``, the rows
    decoded, and every window's two means and decision."""

    def __init__(self, server):
        self.infer_s = self.attention_s = 0.0
        self.infer_calls = self.rows = 0
        self.c1, self.c2, self.decisions = [], [], []
        decoder, rule = server._decoder, server._decide
        infer_pair, attention = decoder.infer_pair, rule.attention

        def timed_infer_pair(*args):
            t0 = time.perf_counter()
            out = infer_pair(*args)
            self.infer_s += time.perf_counter() - t0
            self.infer_calls += 1
            self.rows += len(out[0])
            return out

        def timed_attention(c1, c2):
            t0 = time.perf_counter()
            out = attention(c1, c2)
            self.attention_s += time.perf_counter() - t0
            self.c1.append(c1)
            self.c2.append(c2)
            self.decisions.append(tuple(float(v) for v in out))
            return out
        decoder.infer_pair = timed_infer_pair
        rule.attention = timed_attention

    def zero_spans(self):
        self.infer_s = self.attention_s = 0.0
        self.infer_calls = self.rows = 0


def _ssd_state(server) -> np.ndarray:
    """The state-space rule's carried state, packed, on the host."""
    return torch.cat(list(server._decide._state)).cpu().numpy()


def reference_means(session, weights, cfg, mix, emitted, device,
                    precision='float64'):
    """The reference's two window means of every window due once
    ``emitted`` frames were scored."""
    width, step = mix['window_frames'], mix['step_frames']
    due = ref_decode.windows_for(emitted, width, step)
    s_a, s_b = ref_decode.frame_scores(session, weights, cfg, emitted,
                                       device, precision)
    return (ref_decode.window_means(s_a, due, width, step),
            ref_decode.window_means(s_b, due, width, step))


def compare(mix, limits, ref1, ref2, c1, c2, decisions, snap_windows=(),
            snaps=()) -> dict:
    """The numbers that decide ``correct``: windows missing, the largest
    gap of a window mean (relative to the RMS of the reference's means),
    decisions flipped where the reference's margin is clear of that gap's
    limit, and for the state-space rule the largest gap of (p, lower,
    upper) over the first windows (followed from the initial state) and
    the windows after the state copies (updated from the program's
    state)."""
    n = min(len(c1), len(ref1))
    scale = common.rms(np.concatenate([ref1, ref2]))
    values = {'windows_missing': abs(len(c1) - len(ref1)),
              'score_rel_err': common.max_abs(np.concatenate(
                  [c1[:n] - ref1[:n], c2[:n] - ref2[:n]])) / scale}
    if mix['decision'] == 'ssd':
        start = min(mix['ssd_start_windows'], n)
        got = [decisions[:start]]
        want = [ref_ssd.sequence(ref1, ref2, start)]
        keep = [i for i, w in enumerate(snap_windows)
                if ref_ssd.K_W - 1 <= w < n]
        if keep:
            at = [snap_windows[i] for i in keep]
            got.append(decisions[at])
            want.append(ref_ssd.from_states(
                np.stack([snaps[i] for i in keep]), at, ref1, ref2))
        got, want = np.concatenate(got), np.concatenate(want)
        values['ssd_err'] = common.max_abs(got - want)
        clear = np.abs(want[:, 0] - 0.5) > limits['ssd_err']
        values['decision_flips'] = int(np.sum(
            ((got[:, 0] >= 0.5) != (want[:, 0] >= 0.5)) & clear))
    else:
        clear = (np.abs(ref1[:n] - ref2[:n]) >
                 2 * limits['score_rel_err'] * scale)
        values['decision_flips'] = int(np.sum(
            ((decisions[:n, 0] > 0.5) != ref_decode.wta(ref1[:n], ref2[:n]))
            & clear))
    return values


def run(cfg: dict, mix: dict, limits: dict, seed: int, seconds: float,
        traced: bool, device, process_start: float) -> common.Outcome:
    from telluride_decoding_torch.cli import serve
    chunk, width, step = (mix['chunk_frames'], mix['window_frames'],
                          mix['step_frames'])
    if mix['session_frames'] % chunk:
        raise ValueError('session_frames must be a multiple of chunk_frames')
    ssd = mix['decision'] == 'ssd'
    cuda = device.type == 'cuda'
    stages = {'start': time.perf_counter() - process_start}
    weights = gen.decoder_weights(cfg, seed, device)
    session = gen.serve_session(cfg, mix, seed, device)
    stages['inputs'] = time.perf_counter() - process_start
    eeg, audio1, audio2 = session
    length = eeg.shape[0]
    model_dir = tempfile.mkdtemp(prefix='portbench_model_')
    try:
        write_model(weights, cfg, model_dir)
        decoder = serve._load_serving_decoder(model_dir, None, device)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    stages['model'] = time.perf_counter() - process_start
    server = serve.StreamingAttentionServer(
        decoder, eeg_channels=eeg.shape[1], audio_channels=1,
        window_width=width, window_step=step, decision=mix['decision'],
        frame_rate=cfg['frame_rate'])
    taps = Taps(server)
    pushed = 0

    def push():
        nonlocal pushed
        at = (pushed * chunk) % length
        pushed += 1
        return server.push(eeg[at:at + chunk], audio1[at:at + chunk],
                           audio2[at:at + chunk])

    warm = []
    for _ in range(mix['warmup_pushes']):
        t0 = time.perf_counter()
        push()
        warm.append(time.perf_counter() - t0)
    if cuda:
        torch.cuda.synchronize(device)
    # State copies before windows drawn from the seed: about
    # ssd_sampled_windows of them, spread over the window at the pace of
    # the warm-up's second half.
    snap_rng = np.random.default_rng([seed % 2 ** 64, 7])
    snap_p = 0.0
    if ssd:
        pace = float(np.mean(warm[len(warm) // 2:]))
        snap_p = min(1.0, mix['ssd_sampled_windows'] * pace / seconds)
    snaps, snap_windows = [], []
    taps.zero_spans()
    times = []
    first, first_window = pushed, len(taps.c1)
    stages['warmup'] = time.perf_counter() - process_start
    tracer = trace.Slice(traced, device, trace.SECONDS)
    t_begin = time.perf_counter()
    setup_s = t_begin - process_start
    while True:
        if snap_p and snap_rng.random() < snap_p:
            snap_windows.append(len(taps.c1))
            snaps.append(_ssd_state(server))
        t0 = time.perf_counter()
        push()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        done = t1 - t_begin >= seconds
        tracer.tick(t1 - t_begin, last=done)
        if done:
            break
    window_s = t1 - t_begin
    pushes = pushed - first
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    readings = {
        'kind': 'serve', 'decision': mix['decision'], 'window_s': window_s,
        'setup_stages_s': stages,
        'pushes': pushes, 'push_s': float(np.sum(times)),
        'infer_s': taps.infer_s, 'infer_calls': taps.infer_calls,
        'attention_s': taps.attention_s,
        'rows': taps.rows, 'windows': len(taps.c1) - first_window,
        'f1': cfg['eeg_channels'] * (cfg['eeg_pre'] + 1 + cfg['eeg_post']),
        'f2': cfg['audio_channels'] * (cfg['audio_pre'] + 1 +
                                       cfg['audio_post']),
        'dims': cfg['cca_dims'], 'width': width,
        'ssd_k_w': ref_ssd.K_W if ssd else 0}
    reduced = tracer.reduce()
    if reduced is not None:
        readings['trace'] = reduced
    c1, c2 = np.asarray(taps.c1), np.asarray(taps.c2)
    decisions = np.asarray(taps.decisions)
    del server, decoder, taps
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    emitted = pushed * chunk - max(cfg['eeg_post'], cfg['audio_post'])
    t_ref = time.perf_counter()
    ref1, ref2 = reference_means(session, weights, cfg, mix, emitted,
                                 device)
    values = compare(mix, limits, ref1, ref2, c1, c2, decisions,
                     snap_windows, snaps)
    readings['reference_s'] = time.perf_counter() - t_ref
    checks = common.checks_from(values, limits)
    e2e = {'serve_p95_ms': float(np.percentile(times, 95)) * 1e3,
           'serve_frames_per_s': pushes * chunk / window_s,
           'setup_s': setup_s}
    return common.Outcome(attempted=pushes, failed=0, end_to_end=e2e,
                          readings=readings, checks=checks,
                          memory_peak_bytes=int(peak), trace=reduced)
