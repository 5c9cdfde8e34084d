"""The per-layer metric ``decoder.graph_share``: the program's counter
``decoder.graph_replays`` over the traced slice's ``decoder.infer_pair``
spans, read from a made-up recording, and from a serving cell driven
small on the CPU (no card, so no plan: 0)."""

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from portbench.tests.test_portbench_spans import bench, small  # noqa: E402
from telluride_decoding_torch.utils import profiling  # noqa: E402

NAME = 'decoder.graph_share'
TRACED = {'kind': 'serve', 'trace': {}}


def recording(pushes, counters):
    """``pushes`` serving pushes, each a ``serve.push`` span around one
    ``decoder.infer_pair`` span, and ``counters``."""
    events = []
    for push in range(pushes):
        start = 1000 * push
        events.append(profiling.Event('serve.push', start, start + 900, -1,
                                      push))
        events.append(profiling.Event('decoder.infer_pair', start + 100,
                                      start + 700, len(events) - 1, push))
    return profiling.Recorded(events, counters)


@pytest.mark.parametrize('pushes,replays,share', [
    (4, 3, 0.75), (5, 5, 1.0), (2, None, 0.0)])
def test_share_is_replays_over_infer_pair_spans(monkeypatch, pushes,
                                                replays, share):
    counters = {profiling.HOST_WAITS: pushes}
    if replays is not None:
        counters[profiling.GRAPH_REPLAYS] = replays
    monkeypatch.setattr(profiling, 'recorded',
                        lambda: recording(pushes, counters))
    assert run.read_metric(NAME, TRACED) == share


def test_nothing_to_read(monkeypatch):
    found = recording(3, {profiling.GRAPH_REPLAYS: 3})
    monkeypatch.setattr(profiling, 'recorded', lambda: found)
    assert run.read_metric(NAME, {'kind': 'serve'}) is None   # Untraced.
    assert run.read_metric(NAME, {'kind': 'sweep', 'trace': {}}) is None
    monkeypatch.setattr(profiling, 'recorded',
                        lambda: recording(0, {}))
    assert run.read_metric(NAME, TRACED) is None              # No push.
    # The parent commit's program names no such counter.
    monkeypatch.setattr(profiling, 'recorded', lambda: found)
    monkeypatch.delattr(profiling, 'GRAPH_REPLAYS')
    assert run.read_metric(NAME, TRACED) is None


def test_a_traced_serving_cell_on_the_cpu_reads_zero():
    profiling.reset()
    cfg, mix = small('codelab_cca.serve_wta')
    result, _ = run.execute(bench(), 'codelab_cca.serve_wta', 2 ** 31 + 977,
                            0.3, True, torch.device('cpu'),
                            time.perf_counter(), cfg=cfg, mix=mix)
    assert result['correct']
    assert result['metrics'][NAME] == {'value': 0.0,
                                       'unit': 'replays/call'}
    profiling.reset()
