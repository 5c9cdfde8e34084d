"""The DNN regressor's serving cell (``codelab_dnn.serve_wta``) driven
end to end on the CPU at a small size: the program against the reference
(``correct`` true), faults planted in the prediction and the envelopes
(``correct`` false), the control failing the cell's limits, the traced
run's readers, and the composition's counts against a hand count.

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

from portbench import control_dnn, run  # noqa: E402
from portbench.harness import flops_dnn  # noqa: E402
from portbench.reference import precision  # noqa: E402
from telluride_decoding_torch.cli import serve  # noqa: E402
from telluride_decoding_torch.models import brain_model  # noqa: E402
from telluride_decoding_torch.utils import profiling  # noqa: E402

CPU = torch.device('cpu')
SEED = 2 ** 31 + 1453
CELL = 'codelab_dnn.serve_wta'
READERS = ('dnn.predict_passes', 'dnn.regression_device_ms',
           'dnn.regression_roofline', 'dnn.mfu')


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def small():
    """The cell at a size a CPU test holds: 8 EEG channels and a short
    session; lags, hidden widths, chunks and windows as the cell has
    them."""
    _, cfg, mix, limits = run.cell(bench(), CELL)
    return (dict(cfg, eeg_channels=8),
            dict(mix, session_frames=mix['chunk_frames'] * 256), limits)


def drive(seconds=0.3, traced=False):
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


def test_traced_run_reads_the_regression():
    """No card: the device readers find nothing; the prediction counter
    (one a push, eager on the CPU), the whole push's share and the
    shared serving readers are read, and K1's, S1's and the towers'
    metrics are not reported."""
    result, _ = drive(traced=True)
    assert result['correct']
    metrics = result['metrics']
    assert metrics['dnn.predict_passes']['value'] == 1.0
    assert metrics['dnn.mfu']['value'] > 0
    assert metrics['dnn.host_waits']['value'] == 0.0
    assert 0 <= metrics['dnn.idle_share']['value'] <= 100
    assert metrics['decoder.graph_share']['value'] == 0.0
    assert metrics['decoder.infer_pair_ms']['value'] > 0
    for name in ('dnn.regression_device_ms', 'dnn.regression_roofline',
                 'k1_roofline', 'serve.mfu', 'dcca.tower_passes',
                 's1.window_device_ms', 'serve.host_waits',
                 'device.idle_share.serve'):
        assert name not in metrics


def test_readers_of_a_program_without_the_counter(monkeypatch):
    """A program that names no ``PREDICT_PASSES`` (one without this
    counter) reads no prediction passes and raises nothing; the readers
    of the device trace read nothing without one."""
    _, outcome = drive(traced=True)
    monkeypatch.delattr(profiling, 'PREDICT_PASSES')
    for name in READERS:
        value = run.read_metric(name, outcome.readings)
        assert (value is None) == (name != 'dnn.mfu'), name
    untraced = dict(outcome.readings)
    untraced.pop('trace')
    assert run.read_metric('dnn.regression_device_ms', untraced) is None


def test_device_readers_on_a_trace():
    """On a trace holding K2 and the composition's kernels, the device
    time a push leaves out K2, copies and fills."""
    _, outcome = drive(traced=True)
    readings = dict(outcome.readings, trace={'kernels': {
        'lag_stack_kernel': [0.004, 100],
        'Memcpy HtoD (Pinned -> Device)': [0.5, 100],
        'Memset (Device)': [0.5, 100],
        'ampere_sgemm_32x32_sliced1x4_nn': [0.002, 300],
        'elementwise_kernel': [0.001, 1500]}, 'busy_s': 1.0,
        'window_s': 5.0})
    assert run.read_metric('dnn.regression_device_ms', readings) == \
        pytest.approx(0.03)
    share = run.read_metric('dnn.regression_roofline', readings)
    assert 0 < share < 100
    assert run.read_metric('dnn.idle_share', readings) == pytest.approx(80.0)


def _forward(relu=True, tf32=False):
    """BrainModelDNN._forward at inference, its ReLUs or its products'
    operand precision altered."""
    def forward(self, params, x, training, gen=None, collect_stats=False,
                mesh=None):
        layers = len(self._widths()) - 1
        for i in range(layers):
            w = params['layers/%d/w' % i]
            x = (precision.tf32(x) @ precision.tf32(w) if tf32 else x @ w)
            x = x + params['layers/%d/b' % i]
            if relu and i < layers - 1:
                x = torch.relu(x)
        return x
    return forward


def _one_envelope(monkeypatch):
    # Talker 1's envelope stands in for talker 2's in every push.
    original = serve.StreamingAttentionServer._context_rows

    def context_rows(self, eeg, audio1, audio2):
        rows = original(self, eeg, audio1, audio2)
        return None if rows is None else rows[:4] + (rows[3],)
    monkeypatch.setattr(serve.StreamingAttentionServer, '_context_rows',
                        context_rows)


FAULTS = {
    'dropped_relu': lambda mp: mp.setattr(brain_model.BrainModelDNN,
                                          '_forward', _forward(relu=False)),
    'one_envelope_for_both': _one_envelope,
    'tf32_prediction_product': lambda mp: mp.setattr(
        brain_model.BrainModelDNN, '_forward', _forward(tf32=True)),
}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, outcome = drive(seconds=1.0)
    assert not result['correct'], {c.name: c.value for c in outcome.checks}


def test_control_fails_the_limits():
    cfg, mix, limits = small()
    values, limits = control_dnn.control(CELL, SEED, 16000, CPU, cfg=cfg,
                                         mix=mix, limits=limits)
    assert values['score_rel_err'] > limits['score_rel_err'], values


def test_composition_counts_by_hand():
    """A regressor 3 -> 4 -> 1 over 2 rows: weights and biases 12 + 4 and
    4 + 1 floats a pass, rows 2 x (3 + 4 + 1) floats, and for each of two
    talkers 2 x (1 + 1) floats read and 2 written; products 2 x (2 x 12
    + 2 x 4), bias adds 2 x (4 + 1), ReLUs 2 x 4, and a talker's
    correlation and LDA 2 x (4 + 2 + 2)."""
    assert flops_dnn.push_bytes(2, [3, 4, 1]) == 4 * (21 + 16 + 2 * 6)
    assert flops_dnn.push_bytes(2, [3, 4, 1], calls=2) == 4 * (42 + 16 +
                                                               2 * 6)
    assert flops_dnn.push_flops(2, [3, 4, 1]) == 64 + 10 + 8 + 2 * 16


def test_regressor_dominates_the_push_operations():
    """At the cell's widths the prediction is nearly all of a push's
    operations: about 3.3 MFLOP a 32-frame push, the correlations and the
    LDA 512."""
    _, cfg, _, _ = run.cell(bench(), CELL)
    from portbench.harness import serve_dnn
    sizes = serve_dnn.widths(cfg)
    assert sizes == [2553, 20, 20, 1]
    total = flops_dnn.push_flops(32, sizes)
    assert 3.2e6 < total < 3.4e6
    assert total - 2 * flops_dnn.correlate_flops(32, 1) > 0.99 * total


@pytest.mark.cuda
def test_control_at_cell_size():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the control at the cell\'s size')
    for seed in (SEED, SEED + 1, SEED + 2):
        values, limits = control_dnn.control(CELL, seed, 880000,
                                             torch.device('cuda', 0))
        assert values['score_rel_err'] > limits['score_rel_err'], values
