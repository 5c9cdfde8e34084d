"""Serving cells of VLAAI, a deep convolutional envelope decoder that
reads a raw EEG window: one two-talker session pushed chunk by chunk
through ``cli/serve.py::StreamingAttentionServer.push`` in a closed
loop, as harness/serve_dnn.py pushes the DNN regressor's.

Set-up draws the network's weights, the correlation statistics and LDA,
and the session from the seed, writes the model through
``BrainModelVLAAI.save`` and the decoder's parameters through
``save_parameters`` to a model directory under TMPDIR, loads it as
``cli/serve.py`` does, and pushes the session's first chunks. The window
then pushes the next chunks, looping the session, and times each push on
the host clock; serve.py's ``Taps`` keep the decoder's and the rule's
host spans and every window's means and decision. After the window,
``reference/vlaai.py`` recomputes every window's means from the session
and the weights, and serve.py's ``compare`` gives the numbers that
decide ``correct``.

``control`` is the cell's control: the reference in TF32 against the
reference in float64 (portbench/control_vlaai.py runs it on a card).
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
from portbench.reference import vlaai as ref_vlaai

# A kernel launched once a push on the VLAAI route (the stack of the two
# talkers' scores), which counts the traced slice's pushes.
PUSH_KERNEL = 'CatArrayBatchedCopy'


def model_config(cfg: dict) -> dict:
    """BrainModelVLAAI's constructor config of the configuration."""
    if cfg['context_filters'] != cfg['eeg_channels'] or \
            cfg['dense_units'] != cfg['eeg_channels']:
        raise ValueError('VLAAI adds each block\'s output to the EEG: the '
                         'dense layers and the output context give its '
                         'channels.')
    return {'input_channels': cfg['eeg_channels'],
            'filters': list(cfg['extractor_filters']),
            'kernels': list(cfg['extractor_kernels']),
            'context_kernel': cfg['context_kernel'],
            'blocks': cfg['blocks'], 'output_width': cfg['output_width']}


def vlaai_weights(cfg: dict, seed: int, device) -> dict:
    """The network's weights (convolutions and dense layers N(0, 2 /
    fan_in), biases N(0, 0.01), layer-norm scales 1 + N(0, 0.1) and
    shifts N(0, 0.1)), the correlation statistics and the scaled LDA, as
    float64 host arrays of float32 values (the configuration's
    ``assumed``: seeded, not trained)."""
    rng = gen.generator(seed, 0, device)

    def normal(shape, var):
        return torch.randn(shape, generator=rng, device=device,
                           dtype=torch.float64) * var ** 0.5
    c = cfg['eeg_channels']
    out = {}

    def conv(prefix, k, c_in, c_out):
        out[prefix + 'w'] = normal((k, c_in, c_out), 2.0 / (k * c_in))
        out[prefix + 'b'] = normal((c_out,), 0.01)
        out[prefix + 'gamma'] = 1.0 + normal((c_out,), 0.1)
        out[prefix + 'beta'] = normal((c_out,), 0.1)
    widths = [c] + list(cfg['extractor_filters'])
    for j, k in enumerate(cfg['extractor_kernels']):
        conv('extractor/%d/' % j, k, widths[j], widths[j + 1])
    for i in range(cfg['blocks']):
        out['dense/%d/w' % i] = normal((widths[-1], cfg['dense_units']),
                                       2.0 / widths[-1])
        out['dense/%d/b' % i] = normal((cfg['dense_units'],), 0.01)
    conv('context/', cfg['context_kernel'], c, cfg['context_filters'])
    width = cfg['output_width']
    out['output/w'] = normal((cfg['context_filters'], width),
                             2.0 / cfg['context_filters'])
    out['output/b'] = normal((width,), 0.01)
    out.update({
        'corr_mean_x': normal((width,), 0.01),
        'corr_mean_y': normal((width,), 0.01),
        'corr_power': 1.0 + torch.rand((width,), generator=rng,
                                       device=device, dtype=torch.float64),
        'lda_w': normal((width, 1), 1.0 / width)})
    # Stored in float32 by the model files; the reference takes them so.
    out = {k: v.cpu().numpy().astype(np.float32).astype(np.float64)
           for k, v in out.items()}
    out['lda_slope'] = 0.1
    out['lda_intercept'] = 0.5
    return out


def write_model(weights: dict, cfg: dict, model_dir: str) -> None:
    """The decoder as a model directory: model.json and weights.npz
    (BrainModelVLAAI.save) and decoder_model.json (save_parameters)."""
    from telluride_decoding_torch.decode.infer_decoder import (
        CorrelationParamsTuple, LinearRegressionDecoder, ModelParamsTuple)
    from telluride_decoding_torch.models.vlaai import BrainModelVLAAI
    from telluride_decoding_torch.solvers.lda import LdaParams
    dims = cfg['output_width']
    model = BrainModelVLAAI.from_numpy(
        {k: v for k, v in weights.items()
         if k.startswith(('extractor/', 'dense/', 'context/', 'output/'))},
        'cpu', config=model_config(cfg))
    model.add_metadata({'pre_context': cfg['eeg_pre'],
                        'post_context': cfg['eeg_post'],
                        'input2_pre_context': cfg['audio_pre'],
                        'input2_post_context': cfg['audio_post'],
                        'dnn_regressor': 'vlaai'})
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
    s_a, s_b = ref_vlaai.frame_scores(session, weights, cfg, emitted,
                                      device, precision)
    return (ref_decode.window_means(s_a, due, width, step),
            ref_decode.window_means(s_b, due, width, step))


def control(cfg, mix, limits, seed, frames, device) -> dict:
    """The control's numbers on one seed: the reference in TF32 put in
    the program's place, over ``frames`` scored frames."""
    weights = vlaai_weights(cfg, seed, device)
    session = gen.serve_session(cfg, mix, seed, device)
    ref1, ref2 = reference_means(session, weights, cfg, mix, frames, device)
    c1, c2 = reference_means(session, weights, cfg, mix, frames, device,
                             precision='tf32')
    return serve.compare(mix, limits, ref1, ref2, c1, c2,
                         (c1 > c2)[:, None].astype(float))


def push_device(readings: dict):
    """(seconds, pushes) of a VLAAI serving run's traced slice: the
    device time of every kernel that is neither a copy nor a fill (the
    network's unfolds, products, layer norms, activations and pads, the
    correlations and the LDA), and the pushes counted by PUSH_KERNEL's
    launches, one a push; None where the trace saw none."""
    if readings.get('model') != 'vlaai':
        return None
    seen = trace.kernel(readings, PUSH_KERNEL)
    if seen is None:
        return None
    seconds = sum(v[0] for k, v in readings['trace']['kernels'].items()
                  if not k.startswith(('Memcpy', 'Memset')))
    return seconds, seen[1]


def closed_loop(server, taps, session, mix: dict, seconds: float,
                traced: bool, device, stages: dict, process_start: float):
    """One session through ``server.push`` in a closed loop: the mix's
    warm-up pushes, then pushes timed on the host clock until ``seconds``
    have passed (the first trace.SECONDS traced where ``traced``),
    looping the session end to end. Returns (the window's push times,
    its seconds, set-up seconds, the index of its first window, the
    pushes made in all, the reduced trace or None)."""
    eeg, audio1, audio2 = session
    chunk, length = mix['chunk_frames'], eeg.shape[0]
    pushed = 0

    def push():
        nonlocal pushed
        at = (pushed * chunk) % length
        pushed += 1
        return server.push(eeg[at:at + chunk], audio1[at:at + chunk],
                           audio2[at:at + chunk])

    for _ in range(mix['warmup_pushes']):
        push()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    taps.zero_spans()
    times = []
    first_window = len(taps.c1)
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
    return (times, t1 - t_begin, setup_s, first_window, pushed,
            tracer.reduce())


def run(cfg: dict, mix: dict, limits: dict, seed: int, seconds: float,
        traced: bool, device, process_start: float) -> common.Outcome:
    from telluride_decoding_torch.cli import serve as cli_serve
    chunk, width, step = (mix['chunk_frames'], mix['window_frames'],
                          mix['step_frames'])
    if mix['session_frames'] % chunk:
        raise ValueError('session_frames must be a multiple of chunk_frames')
    if mix['decision'] != 'wta':
        raise ValueError('the VLAAI cells decide by wta')
    cuda = device.type == 'cuda'
    stages = {'start': time.perf_counter() - process_start}
    weights = vlaai_weights(cfg, seed, device)
    session = gen.serve_session(cfg, mix, seed, device)
    stages['inputs'] = time.perf_counter() - process_start
    model_dir = tempfile.mkdtemp(prefix='portbench_model_')
    try:
        write_model(weights, cfg, model_dir)
        decoder = cli_serve._load_serving_decoder(model_dir, None, device)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    stages['model'] = time.perf_counter() - process_start
    server = cli_serve.StreamingAttentionServer(
        decoder, eeg_channels=cfg['eeg_channels'], audio_channels=1,
        window_width=width, window_step=step, decision=mix['decision'],
        frame_rate=cfg['frame_rate'])
    taps = serve.Taps(server)
    times, window_s, setup_s, first_window, pushed, reduced = closed_loop(
        server, taps, session, mix, seconds, traced, device, stages,
        process_start)
    pushes = len(times)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    readings = {
        'kind': 'serve', 'model': 'vlaai', 'decision': mix['decision'],
        'window_s': window_s, 'setup_stages_s': stages,
        'pushes': pushes, 'push_s': float(np.sum(times)),
        'infer_s': taps.infer_s, 'infer_calls': taps.infer_calls,
        'attention_s': taps.attention_s,
        'rows': taps.rows, 'windows': len(taps.c1) - first_window,
        'config': {k: cfg[k] for k in (
            'eeg_channels', 'extractor_filters', 'extractor_kernels',
            'context_filters', 'context_kernel', 'dense_units', 'blocks',
            'output_width')},
        'width': width, 'ssd_k_w': 0}
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
