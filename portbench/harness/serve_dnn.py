"""Serving cells of a regression decoder, the toolbox's fullyconnected
DNN regressor: one two-talker session pushed chunk by chunk through
``cli/serve.py::StreamingAttentionServer.push`` in a closed loop, as
harness/serve.py pushes a CCA decoder's.

Set-up draws the regressor's layers, the correlation statistics and LDA,
and the session from the seed, writes the model through
``BrainModelDNN.save`` and the decoder's parameters through
``save_parameters`` to a model directory under TMPDIR, loads it as
``cli/serve.py`` does, and pushes the session's first chunks. The window
then pushes the next chunks, looping the session, and times each push on
the host clock; serve.py's ``Taps`` keep the decoder's and the rule's
host spans and every window's means and decision. After the window,
``reference/dnn.py`` recomputes every window's means from the session
and the weights, and serve.py's ``compare`` gives the numbers that
decide ``correct``.

``control`` is the cell's control: the reference in TF32 against the
reference in float64 (portbench/control_dnn.py runs it on a card).
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench.harness import common, gen, serve, trace
from portbench.reference import decode as ref_decode
from portbench.reference import dnn as ref_dnn

K2 = 'lag_stack_kernel'


def widths(cfg: dict) -> list:
    """The regressor's layer widths: the lag-stacked EEG, the hidden
    layers, the output."""
    return ([cfg['eeg_channels'] * (cfg['eeg_pre'] + 1 + cfg['eeg_post'])] +
            list(cfg['hidden_units']) + [cfg['output_width']])


def dnn_weights(cfg: dict, seed: int, device) -> dict:
    """The regressor's layers (weights N(0, 2 / fan_in), biases N(0,
    0.01)), the correlation statistics and the scaled LDA, as float64
    host arrays of float32 values (the configuration's ``assumed``:
    seeded, not fitted)."""
    rng = gen.generator(seed, 0, device)
    out_width = cfg['output_width']

    def normal(shape, sd):
        return torch.randn(shape, generator=rng, device=device,
                           dtype=torch.float64) * sd
    sizes = widths(cfg)
    out = {}
    for i in range(len(sizes) - 1):
        out['layers/%d/w' % i] = normal((sizes[i], sizes[i + 1]),
                                        (2.0 / sizes[i]) ** 0.5)
        out['layers/%d/b' % i] = normal((sizes[i + 1],), 0.1)
    out.update({
        'corr_mean_x': normal((out_width,), 0.1),
        'corr_mean_y': normal((out_width,), 0.1),
        'corr_power': 1.0 + torch.rand((out_width,), generator=rng,
                                       device=device, dtype=torch.float64),
        'lda_w': normal((out_width, 1), 1.0 / out_width ** 0.5)})
    # Stored in float32 by the model files; the reference takes them so.
    out = {k: v.cpu().numpy().astype(np.float32).astype(np.float64)
           for k, v in out.items()}
    out['lda_slope'] = 0.1
    out['lda_intercept'] = 0.5
    return out


def write_model(weights: dict, cfg: dict, model_dir: str) -> None:
    """The decoder as a model directory: model.json and weights.npz
    (BrainModelDNN.save) and decoder_model.json (save_parameters)."""
    from telluride_decoding_torch.decode.infer_decoder import (
        CorrelationParamsTuple, LinearRegressionDecoder, ModelParamsTuple)
    from telluride_decoding_torch.models.brain_model import BrainModelDNN
    from telluride_decoding_torch.solvers.lda import LdaParams
    sizes = widths(cfg)
    dims = cfg['output_width']
    model = BrainModelDNN.from_numpy(
        {k: v for k, v in weights.items() if k.startswith('layers/')},
        'cpu', config={'num_hidden_list': list(cfg['hidden_units']),
                       'input_width': sizes[0], 'output_width': dims,
                       'dropout': cfg['dropout'],
                       'batch_norm': cfg['batch_norm']})
    model.add_metadata({'pre_context': cfg['eeg_pre'],
                        'post_context': cfg['eeg_post'],
                        'input2_pre_context': cfg['audio_pre'],
                        'input2_post_context': cfg['audio_post'],
                        'dnn_regressor': 'fullyconnected'})
    model.save(model_dir)
    decoder = LinearRegressionDecoder(model, reduction=cfg['reduction'],
                                      device='cpu')
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


def reference_means(session, weights, cfg, mix, emitted, device,
                    precision='float64'):
    """The reference's two window means of every window due once
    ``emitted`` frames were scored."""
    width, step = mix['window_frames'], mix['step_frames']
    due = ref_decode.windows_for(emitted, width, step)
    s_a, s_b = ref_dnn.frame_scores(session, weights, cfg, emitted, device,
                                    precision)
    return (ref_decode.window_means(s_a, due, width, step),
            ref_decode.window_means(s_b, due, width, step))


def control(cfg, mix, limits, seed, frames, device) -> dict:
    """The control's numbers on one seed: the reference in TF32 put in
    the program's place, over ``frames`` scored frames."""
    weights = dnn_weights(cfg, seed, device)
    session = gen.serve_session(cfg, mix, seed, device)
    ref1, ref2 = reference_means(session, weights, cfg, mix, frames, device)
    c1, c2 = reference_means(session, weights, cfg, mix, frames, device,
                             precision='tf32')
    return serve.compare(mix, limits, ref1, ref2, c1, c2,
                         (c1 > c2)[:, None].astype(float))


def regression_device(readings: dict):
    """(seconds, pushes) of a DNN serving run's traced slice: the device
    time of every kernel that is neither K2 (the EEG's lag stack) nor a
    copy or a fill (the prediction's products, bias adds and ReLUs, the
    correlations and the LDA), and the pushes counted by K2's launches,
    one a push (only the EEG has context); None where the trace saw no
    K2."""
    if readings.get('model') != 'dnn':
        return None
    seen = trace.kernel(readings, K2)
    if seen is None:
        return None
    seconds = sum(v[0] for k, v in readings['trace']['kernels'].items()
                  if K2 not in k and not k.startswith(('Memcpy', 'Memset')))
    return seconds, seen[1]


def run(cfg: dict, mix: dict, limits: dict, seed: int, seconds: float,
        traced: bool, device, process_start: float) -> common.Outcome:
    from telluride_decoding_torch.cli import serve as cli_serve
    chunk, width, step = (mix['chunk_frames'], mix['window_frames'],
                          mix['step_frames'])
    if mix['session_frames'] % chunk:
        raise ValueError('session_frames must be a multiple of chunk_frames')
    if mix['decision'] != 'wta':
        raise ValueError('the DNN cells decide by wta')
    cuda = device.type == 'cuda'
    stages = {'start': time.perf_counter() - process_start}
    weights = dnn_weights(cfg, seed, device)
    session = gen.serve_session(cfg, mix, seed, device)
    stages['inputs'] = time.perf_counter() - process_start
    eeg, audio1, audio2 = session
    length = eeg.shape[0]
    model_dir = tempfile.mkdtemp(prefix='portbench_model_')
    try:
        write_model(weights, cfg, model_dir)
        decoder = cli_serve._load_serving_decoder(model_dir, None, device)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    stages['model'] = time.perf_counter() - process_start
    server = cli_serve.StreamingAttentionServer(
        decoder, eeg_channels=eeg.shape[1], audio_channels=1,
        window_width=width, window_step=step, decision=mix['decision'],
        frame_rate=cfg['frame_rate'])
    taps = serve.Taps(server)
    pushed = 0

    def push():
        nonlocal pushed
        at = (pushed * chunk) % length
        pushed += 1
        return server.push(eeg[at:at + chunk], audio1[at:at + chunk],
                           audio2[at:at + chunk])

    for _ in range(mix['warmup_pushes']):
        push()
    if cuda:
        torch.cuda.synchronize(device)
    taps.zero_spans()
    times = []
    first, first_window = pushed, len(taps.c1)
    stages['warmup'] = time.perf_counter() - process_start
    tracer = trace.Slice(traced, device, trace.SECONDS)
    t_begin = time.perf_counter()
    setup_s = t_begin - process_start
    while True:
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
        'kind': 'serve', 'model': 'dnn', 'decision': mix['decision'],
        'window_s': window_s, 'setup_stages_s': stages,
        'pushes': pushes, 'push_s': float(np.sum(times)),
        'infer_s': taps.infer_s, 'infer_calls': taps.infer_calls,
        'attention_s': taps.attention_s,
        'rows': taps.rows, 'windows': len(taps.c1) - first_window,
        'sizes': widths(cfg), 'width': width, 'ssd_k_w': 0}
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
    values = serve.compare(mix, limits, ref1, ref2, c1, c2, decisions)
    readings['reference_s'] = time.perf_counter() - t_ref
    checks = common.checks_from(values, limits)
    e2e = {'serve_p95_ms': float(np.percentile(times, 95)) * 1e3,
           'serve_frames_per_s': pushes * chunk / window_s,
           'setup_s': setup_s}
    return common.Outcome(attempted=pushes, failed=0, end_to_end=e2e,
                          readings=readings, checks=checks,
                          memory_peak_bytes=int(peak), trace=reduced)
