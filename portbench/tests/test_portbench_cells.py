"""Each cell driven end to end on the CPU at a small size, past the
harness's look for a card: the program's plain paths against the
references (``correct`` true), then the program broken underneath in
each way the cell can break (``correct`` false), and the control (the
reference one precision below) failing the cell's limits.

A cell's own size runs only on a card: ``test_control_at_cell_size``
(marked cuda) runs the control there on three seeds.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import control, run  # noqa: E402
from portbench.reference import ssd as ref_ssd  # noqa: E402
from telluride_decoding_torch.cli import serve  # noqa: E402
from telluride_decoding_torch.decide import attention_decoder  # noqa: E402
from telluride_decoding_torch.decode import infer_decoder  # noqa: E402
from telluride_decoding_torch.decode import result_store  # noqa: E402
from telluride_decoding_torch.sweep import engine  # noqa: E402

CPU = torch.device('cpu')
SEED = 2 ** 31 + 977
CELLS = ('codelab_cca.serve_wta', 'kuleuven_cca.serve_ssd',
         'codelab_cca.sweep_ridge', 'kuleuven_cca.sweep_cca')


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def small(workload):
    """The cell at a size a CPU test holds: 8 EEG channels, a short
    session or a few short files; lags, widths of the lag stacks per
    channel, chunks, windows and lambdas as the cell has them."""
    _, cfg, mix, limits = run.cell(bench(), workload)
    cfg = dict(cfg, eeg_channels=8)
    if mix['kind'] == 'serve':
        mix = dict(mix, session_frames=mix['chunk_frames'] * 256)
        if mix['decision'] == 'ssd':
            # The plain SSD takes a good part of a second a window here.
            mix = dict(mix, warmup_pushes=20, ssd_start_windows=16)
    else:
        mix = dict(mix, files=5, frames=600)
    return cfg, mix, limits


def drive(workload, seconds=0.3):
    cfg, mix, _ = small(workload)
    result, outcome = run.execute(bench(), workload, SEED, seconds, False,
                                  CPU, time.perf_counter(), cfg=cfg, mix=mix)
    return result, {c.name: c for c in outcome.checks}


@pytest.mark.parametrize('workload', CELLS)
def test_program_matches_reference(workload):
    result, checks = drive(workload)
    assert result['correct'], checks
    assert result['attempted'] > 0 and result['failed'] == 0
    expected = {'serve': {'windows_missing', 'score_rel_err',
                          'decision_flips'},
                'sweep': {'grid_err', 'moments_err'}}
    kind = 'serve' if 'serve' in workload else 'sweep'
    names = expected[kind] | ({'ssd_err'} if 'ssd' in workload else set())
    assert set(checks) == names
    assert set(result['metrics']) >= {'setup_s'}


def test_traced_run_reads_its_layers():
    cfg, mix, _ = small('codelab_cca.sweep_ridge')
    result, outcome = run.execute(bench(), 'codelab_cca.sweep_ridge', SEED,
                                  0.3, True, CPU, time.perf_counter(),
                                  cfg=cfg, mix=mix)
    assert result['correct']
    # No card: the device readers find nothing; the spans are read.
    assert set(result['metrics']) == {'sweep.moments_ms', 'sweep.grid_ms',
                                      'device.idle_share.sweep',
                                      'sweep.mfu'}
    assert outcome.trace['busy_s'] == 0.0


def test_ssd_reference_is_the_plain_update():
    rng = np.random.RandomState(3)
    c1 = 0.5 + 0.1 * rng.randn(20)
    c2 = 0.4 + 0.1 * rng.randn(20)
    rule = attention_decoder.create_attention_decoder(
        'ssd', window_step=16, frame_rate=32, device='cpu')
    port = np.asarray([rule.attention(a, b) for a, b in zip(c1, c2)])
    assert np.abs(port - ref_ssd.sequence(c1, c2, 20)).max() < 1e-5
    # From the program's state before window 19, the reference's one
    # update reproduces that window.
    rule = attention_decoder.create_attention_decoder(
        'ssd', window_step=16, frame_rate=32, device='cpu')
    for a, b in zip(c1[:19], c2[:19]):
        rule.attention(a, b)
    state = torch.cat(list(rule._state)).numpy()[None]
    got = ref_ssd.from_states(state, [19], c1, c2)
    assert np.abs(got[0] - port[19]).max() < 1e-5


# Faults planted in the program's timed path. Each is one of the ways a
# cell can go wrong: a step that leaves its state unchanged, half of a
# batch left out with the mean taken over the rest, an answer altered
# where it is produced. (No cell spans chips, so none can leave out an
# exchange between them.)

def _stale_context(monkeypatch):
    # The context buffer emits rows but never moves on.
    original = serve.ContextBuffer.push

    def push(self, frames):
        buf, arrived, emitted = self._buf, self._arrived, self._emitted
        out = original(self, frames)
        if self._pre + self._post:
            self._buf, self._arrived = buf, arrived + len(frames)
            self._emitted = emitted + len(out)
        return out
    monkeypatch.setattr(serve.ContextBuffer, 'push', push)


def _stale_ssd(monkeypatch):
    # S1 returns the state it was given.
    original = attention_decoder.ssd_update

    def ssd_update(state, *args, **kwargs):
        _, z, eta = original(state, *args, **kwargs)
        return state, z, eta
    monkeypatch.setattr(attention_decoder, 'ssd_update', ssd_update)


def _half_windows(monkeypatch):
    # Each window's mean taken over its first half only.
    original = result_store.TwoResultStore.next_window

    def next_window(self):
        for w1, w2 in original(self):
            yield w1[:len(w1) // 2], w2[:len(w2) // 2]
    monkeypatch.setattr(result_store.TwoResultStore, 'next_window',
                        next_window)


def _altered_score(monkeypatch):
    # The decode's 10th call alters one frame's score by 1e-3.
    original = infer_decoder.fused_cca_decode
    calls = [0]

    def fused(*args, **kwargs):
        out = original(*args, **kwargs)
        calls[0] += 1
        if calls[0] == 10:
            out = list(out)
            out[0] = out[0].clone()
            out[0][0] += 1e-3
            out = tuple(out)
        return out
    monkeypatch.setattr(infer_decoder, 'fused_cca_decode', fused)


def _stale_sweep(monkeypatch, sweep_name):
    # Every sweep returns the first sweep's grid.
    original = getattr(engine, sweep_name)
    first = []

    def sweep(*args, **kwargs):
        if not first:
            first.append(original(*args, **kwargs))
        return first[0]
    monkeypatch.setattr(engine, sweep_name, sweep)


def _half_frames(monkeypatch):
    # Each file's moments over the first half of its frames.
    original = engine.device_file_moments

    def moments(x_raw, y_raw, n_true, **kwargs):
        return original(x_raw, y_raw, n_true // 2, **kwargs)
    monkeypatch.setattr(engine, 'device_file_moments', moments)


def _altered_cell(monkeypatch):
    # One cell of every grid altered by 1e-3.
    original = engine._finalize_sweep

    def finalize(*args, **kwargs):
        result = original(*args, **kwargs)
        result.correlations[0, 0] += 1e-3
        return result
    monkeypatch.setattr(engine, '_finalize_sweep', finalize)


FAULTS = [
    ('codelab_cca.serve_wta', _stale_context),
    ('codelab_cca.serve_wta', _half_windows),
    ('codelab_cca.serve_wta', _altered_score),
    ('kuleuven_cca.serve_ssd', _stale_ssd),
    ('kuleuven_cca.serve_ssd', _half_windows),
    ('kuleuven_cca.serve_ssd', _altered_score),
    ('codelab_cca.sweep_ridge',
     lambda mp: _stale_sweep(mp, 'ridge_jackknife_sweep')),
    ('codelab_cca.sweep_ridge', _half_frames),
    ('codelab_cca.sweep_ridge', _altered_cell),
    ('kuleuven_cca.sweep_cca',
     lambda mp: _stale_sweep(mp, 'cca_jackknife_sweep')),
    ('kuleuven_cca.sweep_cca', _half_frames),
    ('kuleuven_cca.sweep_cca', _altered_cell),
]


@pytest.mark.parametrize('workload,fault', FAULTS, ids=[
    '%s-%d' % (w, i) for i, (w, _) in enumerate(FAULTS)])
def test_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    # Long enough for a few sweeps or pushes past the warm-up.
    result, checks = drive(workload, seconds=1.0)
    assert not result['correct'], checks


@pytest.mark.parametrize('workload', CELLS)
def test_control_fails_the_limits(workload):
    cfg, mix, limits = small(workload)
    frames = 16000 if 'wta' in workload else 3000
    values, limits = control.control(workload, SEED, frames, CPU, cfg=cfg,
                                     mix=mix, limits=limits)
    assert any(values[k] > limits[k] for k in values), values


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_control_at_cell_size(workload):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the control at the cell\'s size')
    frames = {'codelab_cca.serve_wta': 880000,
              'kuleuven_cca.serve_ssd': 185000}.get(workload, 0)
    for seed in (SEED, SEED + 1, SEED + 2):
        values, limits = control.control(workload, seed, frames,
                                         torch.device('cuda', 0))
        assert any(values[k] > limits[k] for k in values), values
