#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (telluride_decoding_torch).

Builds the hand-written CUDA kernels from telluride_decoding_torch/csrc,
checks each against its plain PyTorch version on the card at the shapes
the main path gives it, then drives the main path once at codelab width
(69 EEG channels x 37 lags = 2553 columns, 1 audio channel x 31 lags,
10 canonical dimensions):

  1. seeded synthetic recordings: EEG from the attended speaker's
     intensity through a random TRF plus noise, two speakers, and a
     served stream whose attention switches at its midpoint;
  2. file-wise CCA fit on the card (lag stack kernel + moments + solve);
  3. decoder training (correlation statistics + scaled LDA), saved as a
     model directory;
  4. streaming serve through ``telluride_decoding_torch.cli.serve.main``
     (fused CCA decode kernel per chunk), whose decisions must track the
     planted switch and whose scores must match a CPU decode of the same
     stream with the plain versions.

Run from the root of a checkout on a machine with one CUDA card:

  python3 chip_smoke.py

Without a card, or outside a checkout, it exits non-zero and prints no
result. The line before the last holds the kernels' numbers as JSON; the
last line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

IN1_CHANNELS, PRE, POST = 69, 0, 36            # 69 x 37 = 2553 columns.
IN2_PRE, IN2_POST = 15, 15                     # 1 x 31 columns.
CCA_DIMS = 10
TRAIN_FILES, TRAIN_FRAMES, STREAM_FRAMES = 4, 12000, 6000
FLAGSHIP = (512, 100)                          # Windows x frames.
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=1e-3, atol=1e-3)
SERVE_TOL = 1e-4


def log(*parts):
    print(*parts, flush=True)


def time_ms(torch, fn, reps=20, warmup=3):
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(torch, kernel_fn, plain_fn, reps=20):
    """(kernel_ms, plain_ms), each the mean of two timings taken in the
    order plain, kernel, kernel, plain."""
    p1 = time_ms(torch, plain_fn, reps)
    k1 = time_ms(torch, kernel_fn, reps)
    k2 = time_ms(torch, kernel_fn, reps)
    p2 = time_ms(torch, plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def max_err(torch, got, want):
    return float(torch.max(torch.abs(got.float() - want.float())))


def require_close(torch, what, got, want, tol):
    if not torch.allclose(got.float(), want.float(), **tol):
        raise AssertionError('%s disagrees with its plain version: max abs '
                             'err %g (tolerance %s)'
                             % (what, max_err(torch, got, want), tol))
    return max_err(torch, got, want)


def decode_params(torch, rng, f1, f2, dims, device):
    """Random CCA + LDA decode parameters in the JAX bench schema."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return {'mean1': t(rng.randn(1, f1)), 'mean2': t(rng.randn(1, f2)),
            'rot1': t(rng.randn(f1, dims) * 0.02),
            'rot2': t(rng.randn(f2, dims) * 0.2),
            'corr_mean_x': t(rng.randn(dims) * 0.1),
            'corr_mean_y': t(rng.randn(dims) * 0.1),
            'corr_power': t(1.0 + rng.rand(dims)),
            'lda_w': t(rng.randn(dims, 2)), 'lda_slope': t(1.3),
            'lda_intercept': t(-0.25)}


def phase_device(torch):
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]
    capability = torch.cuda.get_device_capability(0)
    log('phase 1 device: %s | torch %s cuda %s | capability %s'
        % (smi, torch.__version__, torch.version.cuda, capability))
    if capability != (9, 0):
        raise AssertionError('needs compute capability (9, 0) for sm_90a, '
                             'got %s' % (capability,))
    from telluride_decoding_torch import kernels
    t0 = time.perf_counter()
    path = kernels.build()
    log('phase 1 build: %s in %.1f s' % (path, time.perf_counter() - t0))
    log_lines = (kernels.BUILD_DIR / 'build.log').read_text().splitlines()
    entry = None
    for line in log_lines:
        if 'Compiling entry function' in line:
            entry = line.split("'")[1]
        elif entry and 'registers' in line and (
                'lag_stack' in entry or 'Li10E' in entry):
            log('phase 1 ptxas: %s: %s' % (entry, line.split(':', 1)[1]
                                            .strip()))
            entry = None
    return smi


def phase_lagstack(torch, device):
    from telluride_decoding_torch.ops.lagstack import (lag_stack,
                                                       lag_stack_reference)
    gen = torch.Generator(device=device).manual_seed(0)
    worst = 0.0
    for n, c, pre, post in [(TRAIN_FRAMES, IN1_CHANNELS, PRE, POST),
                            (STREAM_FRAMES, 1, IN2_PRE, IN2_POST),
                            (1237, 5, 3, 2), (7, 3, 5, 9)]:
        x = torch.randn((n, c), generator=gen, device=device)
        got = lag_stack(x, pre, post)
        want = lag_stack_reference(x, pre, post)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError('lag_stack kernel is not bit-exact at %s'
                                 % ((n, c, pre, post),))
        worst = max(worst, max_err(torch, got, want))
    x = torch.randn((TRAIN_FRAMES, IN1_CHANNELS), generator=gen,
                    device=device)
    ms, plain_ms = interleaved_ms(
        torch, lambda: lag_stack(x, PRE, POST),
        lambda: lag_stack_reference(x, PRE, POST))
    out_bytes = TRAIN_FRAMES * IN1_CHANNELS * (PRE + 1 + POST) * 4
    log('phase 2 lag_stack: bit-exact at 4 shapes; [%d, %d] pre %d post %d: '
        'kernel %.4f ms (%.0f GB/s written), plain %.4f ms'
        % (TRAIN_FRAMES, IN1_CHANNELS, PRE, POST, ms, out_bytes / ms / 1e6,
           plain_ms))
    return {'max_abs_err': worst, 'ms': ms, 'plain_ms': plain_ms}


def phase_decode(torch, device):
    from telluride_decoding_torch.ops.decode_kernel import (
        fold_decode_params, fused_cca_decode, fused_cca_decode_reference)
    rng = np.random.RandomState(1)
    f1, f2 = IN1_CHANNELS * (PRE + 1 + POST), IN2_PRE + 1 + IN2_POST
    folded = fold_decode_params(decode_params(torch, rng, f1, f2, CCA_DIMS,
                                              device))
    gen = torch.Generator(device=device).manual_seed(1)
    worst = 0.0
    for n in (32, 4096):
        x1 = torch.randn((n, 1, f1), generator=gen, device=device)
        x2a = torch.randn((n, 1, f2), generator=gen, device=device)
        x2b = torch.randn((n, 1, f2), generator=gen, device=device)
        want_a = fused_cca_decode_reference(folded, x1, x2a)
        want_b = fused_cca_decode_reference(folded, x1, x2b)
        worst = max(worst, require_close(
            torch, 'fused_cca_decode T=1 N=%d' % n,
            fused_cca_decode(folded, x1, x2a), want_a, F32_TOL))
        pair = fused_cca_decode(folded, x1, x2a, x2b)
        worst = max(worst, require_close(
            torch, 'fused_cca_decode pair N=%d' % n, pair,
            torch.stack([want_a, want_b]), F32_TOL))
        if n == 32:
            serve_ms, serve_plain_ms = interleaved_ms(
                torch, lambda: fused_cca_decode(folded, x1, x2a, x2b),
                lambda: (fused_cca_decode_reference(folded, x1, x2a),
                         fused_cca_decode_reference(folded, x1, x2b)))
    w, t = FLAGSHIP
    x1 = torch.randn((w, t, f1), generator=gen,
                     device=device).to(torch.bfloat16)
    x2 = torch.randn((w, t, f2), generator=gen,
                     device=device).to(torch.bfloat16)
    worst = max(worst, require_close(
        torch, 'fused_cca_decode flagship bf16',
        fused_cca_decode(folded, x1, x2),
        fused_cca_decode_reference(folded, x1, x2), BF16_TOL))
    ms, plain_ms = interleaved_ms(
        torch, lambda: fused_cca_decode(folded, x1, x2),
        lambda: fused_cca_decode_reference(folded, x1, x2), reps=10)
    floor_ms = time_ms(torch, lambda: torch.sum(x1), reps=10)
    in_bytes = (x1.numel() + x2.numel()) * 2
    log('phase 3 fused_cca_decode: matches plain at T=1 N in {32, 4096} '
        'single and pair (f32), and at %d x %d x %d bf16; serving pair N=32: '
        'kernel %.4f ms, plain %.4f ms; flagship: kernel %.4f ms (%.0f GB/s), '
        'plain %.4f ms, read floor torch.sum(x1) %.4f ms (%.0f GB/s)'
        % (w, t, f1, serve_ms, serve_plain_ms, ms, in_bytes / ms / 1e6,
           plain_ms, floor_ms, x1.numel() * 2 / floor_ms / 1e6))
    return {'max_abs_err': worst, 'ms': ms, 'plain_ms': plain_ms}


def _speaker(rng, n):
    """A positive, smooth intensity envelope (10 Hz knots at 100 Hz)."""
    raw = np.abs(rng.randn(n // 10 + 2))
    idx = np.linspace(0, raw.shape[0] - 1.001, n)
    lo = idx.astype(int)
    frac = idx - lo
    return ((1 - frac) * raw[lo] + frac * raw[lo + 1]).astype(
        np.float32)[:, None]


def synthetic_recordings(seed, channels, files, frames, stream_frames):
    """Training files (eeg, attended, unattended) and a served stream
    whose attention moves from speaker 1 to speaker 2 at its midpoint."""
    rng = np.random.RandomState(seed)
    lags = np.arange(25)
    trf = rng.randn(channels, lags.size) * np.exp(-lags / 8.0)

    def eeg(attended):
        n = attended.shape[0]
        clean = np.stack([np.convolve(attended[:, 0], trf[c])[:n]
                          for c in range(channels)], axis=1)
        return (clean + 2.0 * rng.randn(n, channels)).astype(np.float32)
    train = []
    for _ in range(files):
        a1, a2 = _speaker(rng, frames), _speaker(rng, frames)
        train.append((eeg(a1), a1, a2))
    a1, a2 = _speaker(rng, stream_frames), _speaker(rng, stream_frames)
    switch = (np.arange(stream_frames) >= stream_frames // 2)[:, None]
    stream = (eeg(np.where(switch, a2, a1)), a1, a2)
    return train, stream


def run_slice(device, model_dir, channels=IN1_CHANNELS, files=TRAIN_FILES,
              frames=TRAIN_FRAMES, stream_frames=STREAM_FRAMES,
              dims=CCA_DIMS, contexts=(PRE, POST, IN2_PRE, IN2_POST)):
    """Fit, train, save and serve; returns (decisions, summary, times)."""
    import torch
    from telluride_decoding_torch.cli import serve
    from telluride_decoding_torch.decode.infer_decoder import CCADecoder
    from telluride_decoding_torch.models.cca import BrainModelCCA
    from telluride_decoding_torch.ops.lagstack import lag_stack

    pre, post, pre2, post2 = contexts
    train, stream = synthetic_recordings(7, channels, files, frames,
                                         stream_frames)
    times = {}
    t0 = time.perf_counter()
    model = BrainModelCCA(cca_dims=dims, regularization_lambda=1e-3,
                          device=device)
    model.fit_streaming([(e, a) for e, a, _ in train], pre=pre, post=post,
                        pre_y=pre2, post_y=post2)
    times['fit_s'] = time.perf_counter() - t0

    t0 = time.perf_counter()

    def dataset(speaker):
        for recording in train:
            eeg = torch.as_tensor(recording[0], device=model.device)
            audio = torch.as_tensor(recording[speaker], device=model.device)
            yield ({'input_1': lag_stack(eeg, pre, post),
                    'input_2': lag_stack(audio, pre2, post2)},
                   recording[speaker])
    decoder = CCADecoder(model, reduction='lda', device=device)
    dprime = decoder.train(dataset(2), dataset(1), window_size=100)
    model.add_metadata({'pre_context': pre, 'post_context': post,
                        'input2_pre_context': pre2,
                        'input2_post_context': post2,
                        'dnn_regressor': 'cca'})
    model.save(model_dir)
    decoder.save_parameters(os.path.join(model_dir, 'decoder_model.json'))
    times['train_s'] = time.perf_counter() - t0
    times['dprime'] = dprime

    stream_path = os.path.join(model_dir, 'stream.npz')
    out_path = os.path.join(model_dir, 'decisions.jsonl')
    np.savez(stream_path, eeg=stream[0], audio1=stream[1], audio2=stream[2])
    t0 = time.perf_counter()
    serve.main(['--serve_model_dir', model_dir, '--serve_input', stream_path,
                '--serve_output', out_path, '--chunk_size', '32',
                '--serve_window_width', '100', '--serve_window_step', '50',
                '--serve_decoder', 'wta', '--serve_device', str(device)])
    times['serve_s'] = time.perf_counter() - t0
    with open(out_path) as f:
        lines = [json.loads(line) for line in f]
    return [l for l in lines if 'window' in l], lines[-1], stream, times


def check_decisions(decisions, summary, stream_frames=STREAM_FRAMES):
    """Fraction of windows on the planted side of the switch; raises
    unless it is above 0.9 and every score is finite."""
    switch_s = (stream_frames // 2) / 100.0
    if not decisions or summary.get('windows') != len(decisions):
        raise AssertionError('serve produced %d decisions, summary %s'
                             % (len(decisions), summary))
    scores = [d[k] for d in decisions for k in ('score1', 'score2')]
    if not np.all(np.isfinite(scores)):
        raise AssertionError('non-finite served scores')
    correct = sum(d['attend_speaker1'] != (d['time_s'] >= switch_s)
                  for d in decisions) / len(decisions)
    if correct <= 0.9:
        raise AssertionError('decisions track the switch in only %.3f of '
                             'windows' % correct)
    return correct


def check_against_plain(decisions, model_dir, stream,
                        contexts=(PRE, POST, IN2_PRE, IN2_POST)):
    """Served window scores vs a CPU decode of the same stream with the
    plain versions (the served scores are rounded to 6 decimals)."""
    from telluride_decoding_torch.cli import serve
    from telluride_decoding_torch.ops.lagstack import lag_stack_np
    pre, post, pre2, post2 = contexts
    eeg, a1, a2 = stream
    n = eeg.shape[0] - max(post, post2)
    decoder = serve.load_model(model_dir, 'lda', 'cpu')
    s1, s2 = decoder.infer_pair(lag_stack_np(eeg, pre, post)[:n],
                                lag_stack_np(a1, pre2, post2)[:n],
                                lag_stack_np(a2, pre2, post2)[:n],
                                a1[:n], a2[:n])
    worst = 0.0
    for d in decisions:
        start = d['window'] * 50
        for key, scores in (('score1', s1), ('score2', s2)):
            worst = max(worst, abs(d[key] - float(np.mean(
                scores[start:start + 100]))))
    if worst > SERVE_TOL:
        raise AssertionError('served scores differ from the plain decode by '
                             '%g' % worst)
    return worst


def phase_slice(torch, device, smi):
    from telluride_decoding_torch.ops.decode_kernel import fused_cca_decode
    from telluride_decoding_torch.ops.lagstack import lag_stack
    model_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             'build', 'chip_smoke_model')
    lag_stack.launches = 0
    fused_cca_decode.launches = 0
    decisions, summary, stream, times = run_slice(device, model_dir)
    launches = {'lag_stack': lag_stack.launches,
                'fused_cca_decode': fused_cca_decode.launches}
    correct = check_decisions(decisions, summary)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError('the main path never launched %s' % name)
    worst = check_against_plain(decisions, model_dir, stream)
    log('phase 4 slice: fit %.2f s, train %.2f s (dprime %.2f), serve %.2f s;'
        ' %d windows served, %.3f on the planted side of the switch; '
        'latency p50 %.3f ms p95 %.3f ms; served scores within %.2g of the '
        'plain CPU decode; launches %s; %s'
        % (times['fit_s'], times['train_s'], times['dprime'],
           times['serve_s'], len(decisions), correct,
           summary['latency_p50_ms'], summary['latency_p95_ms'], worst,
           launches, smi))
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available.', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from telluride_decoding_torch.device import cuda_device
    device = cuda_device(0)
    smi = phase_device(torch)
    k2 = phase_lagstack(torch, device)
    k1 = phase_decode(torch, device)
    launches = phase_slice(torch, device, smi)
    kernels = [
        dict(name='fused_cca_decode', route='cuda',
             source='telluride_decoding_torch/csrc/decode_kernel.cu',
             replaces='telluride_decoding_tpu/ops/decode_kernel.py:123',
             launches=launches['fused_cca_decode'], **k1),
        dict(name='lag_stack', route='cuda',
             source='telluride_decoding_torch/csrc/lagstack.cu',
             replaces='telluride_decoding_tpu/ops/lagstack.py:93',
             launches=launches['lag_stack'], **k2),
    ]
    log(smi)
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
