"""The per-layer metric ``decoder.device_stack_share``: the program's
counter ``decoder.device_stacks`` over the traced slice's
``decoder.infer_pair`` spans, read from a made-up recording, and from a
serving cell driven small on the CPU (no card, so no plan: 0)."""

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402
from portbench.tests.test_portbench_graph_share import (  # noqa: E402
    TRACED, recording)
from portbench.tests.test_portbench_spans import bench, small  # noqa: E402
from telluride_decoding_torch.utils import profiling  # noqa: E402

NAME = 'decoder.device_stack_share'


@pytest.mark.parametrize('pushes,stacks,share', [
    (4, 3, 0.75), (5, 5, 1.0), (2, None, 0.0)])
def test_share_is_device_stacks_over_infer_pair_spans(monkeypatch, pushes,
                                                      stacks, share):
    counters = {profiling.HOST_WAITS: pushes,
                profiling.GRAPH_REPLAYS: pushes}
    if stacks is not None:
        counters[profiling.DEVICE_STACKS] = stacks
    monkeypatch.setattr(profiling, 'recorded',
                        lambda: recording(pushes, counters))
    assert run.read_metric(NAME, TRACED) == share


def test_nothing_to_read(monkeypatch):
    found = recording(3, {profiling.DEVICE_STACKS: 3})
    monkeypatch.setattr(profiling, 'recorded', lambda: found)
    assert run.read_metric(NAME, {'kind': 'serve'}) is None   # Untraced.
    assert run.read_metric(NAME, {'kind': 'sweep', 'trace': {}}) is None
    monkeypatch.setattr(profiling, 'recorded',
                        lambda: recording(0, {}))
    assert run.read_metric(NAME, TRACED) is None              # No push.
    # A program before raw-window plans names no such counter.
    monkeypatch.setattr(profiling, 'recorded', lambda: found)
    monkeypatch.delattr(profiling, 'DEVICE_STACKS')
    assert run.read_metric(NAME, TRACED) is None


def test_a_traced_serving_cell_on_the_cpu_reads_zero():
    profiling.reset()
    cfg, mix = small('codelab_cca.serve_wta')
    result, _ = run.execute(bench(), 'codelab_cca.serve_wta', 2 ** 31 + 977,
                            0.3, True, torch.device('cpu'),
                            time.perf_counter(), cfg=cfg, mix=mix)
    assert result['correct']
    assert result['metrics'][NAME] == {'value': 0.0, 'unit': 'stacks/call'}
    profiling.reset()
