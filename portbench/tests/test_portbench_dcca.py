"""The deep CCA serving cell (``codelab_dcca.serve_wta``) driven end to
end on the CPU at a small size: the program against the reference
(``correct`` true), faults planted in the towers (``correct`` false),
the control failing the cell's limits, the traced run's readers, and the
towers' counts against a hand count.

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

from portbench import control_dcca, run  # noqa: E402
from portbench.harness import flops, flops_dcca  # noqa: E402
from portbench.reference import precision  # noqa: E402
from telluride_decoding_torch.models import cca  # noqa: E402

CPU = torch.device('cpu')
SEED = 2 ** 31 + 977
CELL = 'codelab_dcca.serve_wta'


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def small():
    """The cell at a size a CPU test holds: 8 EEG channels and a short
    session; lags, hidden widths, D, chunks and windows as the cell has
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
    assert set(result['metrics']) == {'serve_p95_ms', 'serve_frames_per_s',
                                      'setup_s'}


def test_traced_run_reads_the_towers():
    """No card: the device readers find nothing; the towers' span, the
    counter (3 a push, eager on the CPU) and the whole push's share are
    read, and the CCA's K1 counts are not reported."""
    result, _ = drive(traced=True)
    assert result['correct']
    metrics = result['metrics']
    assert metrics['dcca.tower_passes']['value'] == 3.0
    assert metrics['dcca.eager_towers_ms']['value'] > 0
    assert metrics['dcca.serve_mfu']['value'] > 0
    assert metrics['decoder.graph_share']['value'] == 0.0
    for name in ('dcca.towers_device_ms', 'dcca.towers_roofline',
                 'k1_roofline', 'serve.mfu'):
        assert name not in metrics


def _altered_tower(monkeypatch):
    # The towers' 10th call scales one frame's EEG tower output by 1.01.
    original = cca.BrainModelDCCA.towers
    calls = [0]

    def towers(self):
        apply = original(self)

        def altered(x1, x2s):
            h1, h2s = apply(x1, x2s)
            calls[0] += 1
            if calls[0] == 10:
                h1 = h1.clone()
                h1[0] *= 1.01
            return h1, h2s
        return altered
    monkeypatch.setattr(cca.BrainModelDCCA, 'towers', towers)


def _mlp(relu=True, tf32=False):
    def apply_mlp(params, x, layers, prefix='', final_activation=None):
        for i in range(layers):
            w = params['%s%d/w' % (prefix, i)]
            x = (precision.tf32(x) @ precision.tf32(w) if tf32 else x @ w)
            x = x + params['%s%d/b' % (prefix, i)]
            if relu and i < layers - 1:
                x = torch.relu(x)
        return x
    return apply_mlp


FAULTS = {
    'altered_tower_output': _altered_tower,
    'dropped_relu': lambda mp: mp.setattr(cca, '_apply_mlp',
                                          _mlp(relu=False)),
    'tf32_tower_product': lambda mp: mp.setattr(cca, '_apply_mlp',
                                                _mlp(tf32=True)),
}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, outcome = drive(seconds=1.0)
    assert not result['correct'], {c.name: c.value for c in outcome.checks}


def test_control_fails_the_limits():
    cfg, mix, limits = small()
    values, limits = control_dcca.control(CELL, SEED, 16000, CPU, cfg=cfg,
                                          mix=mix, limits=limits)
    assert values['score_rel_err'] > limits['score_rel_err'], values


def test_tower_counts_by_hand():
    """One tower 3 -> 4 -> 2 over 2 rows: weights and biases 12 + 4 and
    8 + 2 floats a pass, rows 2 x (3 + 4 + 2) floats; products 2 x (2 x
    12 + 2 x 8), bias adds 2 x (4 + 2), ReLUs 2 x 4."""
    assert flops_dcca.tower_bytes(2, [3, 4, 2]) == 4 * (26 + 18)
    assert flops_dcca.tower_bytes(2, [3, 4, 2], passes=3) == 4 * (78 + 18)
    assert flops_dcca.tower_flops(2, [3, 4, 2]) == 80 + 12 + 8
    # A pair: the EEG tower once, the audio tower for each talker.
    assert flops_dcca.pair_flops(2, 3, 5, [4], 2) == (
        flops_dcca.tower_flops(2, [3, 4, 2]) +
        2 * flops_dcca.tower_flops(2, [5, 4, 2]))
    assert flops_dcca.pair_bytes(2, 3, 5, [4], 2, calls=1) == 4 * (
        26 + 18 + 2 * ((20 + 4 + 8 + 2) + 2 * (5 + 4 + 2)))


def test_towers_dominate_the_push_operations():
    """At the cell's widths the towers are most of a push's operations:
    about 23 MFLOP against K1's 0.02 on the tower outputs."""
    _, cfg, _, _ = run.cell(bench(), CELL)
    f1 = cfg['eeg_channels'] * (cfg['eeg_pre'] + 1 + cfg['eeg_post'])
    f2 = cfg['audio_pre'] + 1 + cfg['audio_post']
    dims, hidden = cfg['cca_dims'], cfg['hidden_units']
    towers = flops_dcca.pair_flops(32, f1, f2, hidden, dims)
    k1 = flops.k1_flops(32, dims, dims, dims)
    assert (f1, f2) == (2553, 31)
    assert 22e6 < towers < 24e6 and towers > 500 * k1


@pytest.mark.cuda
def test_control_at_cell_size():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the control at the cell\'s size')
    for seed in (SEED, SEED + 1, SEED + 2):
        values, limits = control_dcca.control(CELL, seed, 880000,
                                              torch.device('cuda', 0))
        assert values['score_rel_err'] > limits['score_rel_err'], values
