"""VLAAI's serving cell (``kuleuven_vlaai.serve_wta``) driven end to end
on the CPU at a small size: the program against the reference
(``correct`` true), faults planted in the functions of models/vlaai.py
that the card's route runs too, inside the push plan's graph (``correct``
false), the control failing the cell's limits, the traced run's readers,
and the minimal work against a hand count.

The cell's own size runs only on a card: ``test_control_at_cell_size``
(marked cuda) runs the control there on three seeds.
"""

import json
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import control_vlaai, run  # noqa: E402
from portbench.harness import flops_vlaai, serve_vlaai  # noqa: E402
from telluride_decoding_torch.models import vlaai  # noqa: E402
from telluride_decoding_torch.utils import profiling  # noqa: E402

CPU = torch.device('cpu')
SEED = 2 ** 31 + 2711
CELL = 'kuleuven_vlaai.serve_wta'
READERS = ('vlaai.push_device_ms', 'vlaai.model_roofline',
           'vlaai.frames_read', 'vlaai.mfu', 'vlaai.idle_share')


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def small():
    """The cell at a size a CPU test holds: 8 EEG channels, extractor
    filters 16-16-16-8-8, 2 blocks (a window context of 62 and 70
    frames) and a short session; kernels, chunks and windows as the cell
    has them."""
    _, cfg, mix, limits = run.cell(bench(), CELL)
    return (dict(cfg, eeg_channels=8, extractor_filters=[16, 16, 16, 8, 8],
                 context_filters=8, dense_units=8, blocks=2, eeg_pre=62,
                 eeg_post=70),
            dict(mix, session_frames=mix['chunk_frames'] * 256), limits)


def drive(seconds=0.5, traced=False):
    cfg, mix, _ = small()
    return run.execute(bench(), CELL, SEED, seconds, traced, CPU,
                       time.perf_counter(), cfg=cfg, mix=mix)


def test_cell_matches_reference():
    result, outcome = drive()
    checks = {c.name: c for c in outcome.checks}
    assert result['correct'], checks
    assert result['attempted'] > 0 and result['failed'] == 0
    assert set(checks) == {'windows_missing', 'score_rel_err',
                           'decision_flips'}
    assert set(result['metrics']) == {'serve_p95_ms', 'setup_s'}
    assert outcome.readings['windows'] > 0


def test_traced_run_reads_the_window_model():
    """No card: the device readers find nothing; the frames read a row
    (rows + 132 a push of 32 rows), the whole push's share and the
    shared serving readers are read, and no other cell's metrics are
    reported."""
    profiling.reset()
    result, _ = drive(traced=True)
    assert result['correct']
    metrics = result['metrics']
    assert metrics['vlaai.frames_read']['value'] == (32 + 132) / 32
    assert metrics['vlaai.mfu']['value'] > 0
    assert 0 <= metrics['vlaai.idle_share']['value'] <= 100
    assert metrics['decoder.graph_share']['value'] == 0.0
    for name in ('serve.loop_self_ms', 'decoder.infer_pair_ms',
                 'decide.window_ms', 'serve.context_ms',
                 'decoder.copy_in_ms', 'decoder.launch_ms',
                 'decoder.copy_out_ms', 'serve.store_ms'):
        assert metrics[name]['value'] > 0, name
    for name in ('vlaai.push_device_ms', 'vlaai.model_roofline',
                 'dnn.predict_passes', 'k1_roofline', 'serve.mfu',
                 'device.idle_share.serve', 'decoder.device_stack_share'):
        assert name not in metrics
    profiling.reset()


def test_readers_of_a_program_without_the_counter(monkeypatch):
    """A program that names no ``WINDOW_FRAMES`` (one without this
    counter) reads no frames a row and raises nothing; the readers of
    the device trace read nothing without one, and none reads another
    cell's run."""
    _, outcome = drive(traced=True)
    monkeypatch.delattr(profiling, 'WINDOW_FRAMES')
    for name in READERS:
        value = run.read_metric(name, outcome.readings)
        assert (value is None) == (name not in ('vlaai.mfu',
                                                'vlaai.idle_share')), name
    untraced = dict(outcome.readings)
    untraced.pop('trace')
    assert run.read_metric('vlaai.push_device_ms', untraced) is None
    other = dict(outcome.readings, model='dnn')
    assert all(run.read_metric(n, other) is None for n in READERS)


def test_device_readers_on_a_trace():
    """On a trace holding the network's kernels, the device time a push
    leaves out copies and fills and counts pushes by the stack of the
    talkers' scores."""
    _, outcome = drive(traced=True)
    readings = dict(outcome.readings, trace={'kernels': {
        'Memcpy HtoD (Pinned -> Device)': [0.5, 100],
        'Memset (Device)': [0.5, 100],
        'void at::native::CatArrayBatchedCopy<float>': [0.001, 100],
        'sm90_xmma_gemm_f32f32_f32f32': [0.009, 3300],
        'vectorized_layer_norm_kernel': [0.004, 2400],
        'elementwise_kernel': [0.001, 5000]}, 'busy_s': 1.0,
        'window_s': 5.0})
    assert run.read_metric('vlaai.push_device_ms', readings) == \
        pytest.approx(0.15)
    share = run.read_metric('vlaai.model_roofline', readings)
    assert 0 < share < 100
    assert run.read_metric('vlaai.idle_share', readings) == \
        pytest.approx(80.0)


def _blocks(skip=True, one_dense=False):
    """vlaai.run_blocks without the skip of the EEG into blocks after
    the first, or with block 0's dense layer in every block."""
    def run_blocks(params, e, count, layers):
        x = torch.zeros_like(e)
        for i in range(count):
            h = vlaai.extractor(params, e + x if skip or i == 0 else x,
                                layers)
            d = 0 if one_dense else i
            h = torch.addmm(params['dense/%d/b' % d], h,
                            params['dense/%d/w' % d])
            x = vlaai.output_context(params, h)
        return x
    return run_blocks


def _extractor_padded_at_start(params, h, layers):
    for j in range(layers):
        k = params['extractor/%d/w' % j].shape[0]
        h = torch.nn.functional.pad(
            vlaai.conv_ln_act(h, params, 'extractor/%d/' % j),
            (0, 0, k - 1, 0))
    return h


FAULTS = {
    'dropped_skip': lambda mp: mp.setattr(vlaai, 'run_blocks',
                                          _blocks(skip=False)),
    'extractor_padded_at_start': lambda mp: mp.setattr(
        vlaai, 'extractor', _extractor_padded_at_start),
    'slope_0.01': lambda mp: mp.setattr(
        vlaai, 'activation',
        lambda h: torch.nn.functional.leaky_relu(h, 0.01)),
    'one_dense_for_every_block': lambda mp: mp.setattr(
        vlaai, 'run_blocks', _blocks(one_dense=True)),
}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, outcome = drive(seconds=1.0)
    assert not result['correct'], {c.name: c.value for c in outcome.checks}


def test_control_fails_the_limits():
    cfg, mix, limits = small()
    values, limits = control_vlaai.control(CELL, SEED, 16000, CPU, cfg=cfg,
                                           mix=mix, limits=limits)
    assert values['score_rel_err'] > limits['score_rel_err'], values


def test_minimal_work_by_hand():
    """At the published widths a row is 6,848,576 multiply-adds: a
    block's five extractor convolutions 8 x (64 x 256 + 256 x 256 x 2 +
    256 x 128 + 128 x 128) = 1,572,864, its dense layer 128 x 64 = 8,192
    and its output context 32 x 64 x 64 = 131,072, four blocks, and the
    output layer's 64; the weights are 1,740,289 floats. A 32-row push
    then needs 438 MFLOP, 6.54 us at the float32 peak (the weights take
    2.08 us at the HBM rate)."""
    _, cfg, _, _ = run.cell(bench(), CELL)
    assert flops_vlaai.row_flops(cfg) == 2 * 6848576
    assert flops_vlaai.parameters(cfg) == 1740289
    assert flops_vlaai.weight_bytes(cfg) == 4 * 1740289
    assert flops_vlaai.least_push_s(cfg, 32) == pytest.approx(
        32 * 2 * 6848576 / 67e12)
    assert flops_vlaai.least_push_s(cfg, 64, calls=2) == pytest.approx(
        2 * flops_vlaai.least_push_s(cfg, 32))
    model = vlaai.BrainModelVLAAI(
        **serve_vlaai.model_config(cfg), device='cpu')
    assert model.window_context == (cfg['eeg_pre'], cfg['eeg_post'])


@pytest.mark.cuda
def test_control_at_cell_size():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the control at the cell\'s size')
    for seed in (SEED, SEED + 1, SEED + 2):
        values, limits = control_vlaai.control(CELL, seed, 5000000,
                                               torch.device('cuda', 0))
        assert values['score_rel_err'] > limits['score_rel_err'], values
