"""The per-layer metrics that read the program's own spans and counters
(``utils/profiling.py``'s recorder, through harness/spans.py), each cell
driven small on the CPU: traced, each reads a finite number in the cells
it names; untraced, none reads anything; the serving spans cover the
push."""

import json
import math
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from telluride_decoding_torch.utils import profiling  # noqa: E402

CPU = torch.device('cpu')
# test_portbench_cells.py's seed: its moments tap keeps the first sweep's
# file, so a window of one sweep (a loaded CPU) is still whole.
SEED = 2 ** 31 + 977
CELLS = ('codelab_cca.serve_wta', 'kuleuven_cca.serve_ssd',
         'codelab_cca.sweep_ridge', 'kuleuven_cca.sweep_cca')
NEW = ('serve.context_ms', 'decoder.copy_in_ms', 'decoder.launch_ms',
       'decoder.copy_out_ms', 'serve.store_ms', 'serve.host_waits',
       's1.wait_ms', 'sweep.upload_ms', 'sweep.lam_chunk_ms',
       'sweep.readback_ms', 'sweep.host_waits')


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def small(workload):
    """The cell at a CPU test's size: 8 EEG channels, a short session or
    five short files; lags, chunks, windows and lambdas as the cell has
    them."""
    _, cfg, mix, _ = run.cell(bench(), workload)
    cfg = dict(cfg, eeg_channels=8)
    if mix['kind'] == 'serve':
        mix = dict(mix, session_frames=mix['chunk_frames'] * 256)
        if mix['decision'] == 'ssd':
            # The plain SSD takes a good part of a second a window here.
            mix = dict(mix, warmup_pushes=20, ssd_start_windows=16)
    else:
        mix = dict(mix, files=5, frames=600)
    return cfg, mix


def drive(workload, traced):
    cfg, mix = small(workload)
    return run.execute(bench(), workload, SEED, 0.3, traced, CPU,
                       time.perf_counter(), cfg=cfg, mix=mix)


def test_every_new_metric_is_declared_once():
    per_layer = {m['name']: m for m in bench()['per_layer']}
    for name in NEW:
        assert per_layer[name]['source'] in ('program_span',
                                             'program_counter')


@pytest.mark.parametrize('workload', CELLS)
def test_new_metrics_read_only_in_a_traced_run(workload):
    profiling.reset()
    result, _ = drive(workload, True)
    assert result['correct']
    per_layer = {m['name']: m for m in bench()['per_layer']}
    named = [n for n in NEW if workload in per_layer[n]['workloads']]
    assert named
    for name in named:
        value = result['metrics'][name]['value']
        assert math.isfinite(value) and value >= 0, (name, value)
    if 'serve' in workload:
        assert result['metrics']['serve.host_waits']['value'] == 0  # CPU.
        spans = profiling.span_totals(profiling.recorded().events)
        push = spans['serve.push']
        # The context, the decoder and the store (the rule inside it)
        # cover the push.
        assert push.self_ns <= 0.1 * push.total_ns, push
    # Untraced (the traced run's spans still held): nothing is read.
    result, outcome = drive(workload, False)
    assert result['correct']
    for name in NEW:
        assert run.read_metric(name, outcome.readings) is None, name
    profiling.reset()


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    """The parent commit's program has no ``recorded``: a traced run
    there leaves the new metrics out instead of failing."""
    profiling.reset()
    _, outcome = drive('codelab_cca.sweep_ridge', True)
    monkeypatch.delattr(profiling, 'recorded')
    for name in NEW:
        assert run.read_metric(name, outcome.readings) is None, name
    profiling.reset()
