"""Host utilities of the PyTorch port vs the JAX package: the TF event
file writer and the stage timer are copies, so with the clocks held
fixed their outputs are equal byte for byte; the trace writes a
torch.profiler Chrome trace."""

import itertools
import json
import os
import time

import torch

from telluride_decoding_tpu.utils import profiling as jax_profiling
from telluride_decoding_tpu.utils import summaries as jax_summaries
from telluride_decoding_torch.utils import profiling, summaries


def _write_events(module, logdir):
    writer = module.SummaryWriter(logdir)
    writer.scalar('dprime', 7.25, step=100)
    writer.scalar('loss', 0.5)
    writer.text('Parameters', 'batch_size=512 dnn_regressor=cca', step=3)
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name), 'rb') as f:
        return name, f.read()


def test_summary_writer_bytes_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, 'time', lambda: 1700000000.25)
    got = _write_events(summaries, str(tmp_path / 'port'))
    want = _write_events(jax_summaries, str(tmp_path / 'jax'))
    assert got == want
    assert got[0].startswith('events.out.tfevents.1700000000.')


def _timed_report(module, monkeypatch):
    ticks = itertools.count(0.0, 0.125)
    monkeypatch.setattr(time, 'perf_counter', lambda: next(ticks))
    timer = module.StageTimer('run_decoding_experiment')
    for name in ('data_discovery', 'train_and_test', 'train_and_test',
                 'train_lda'):
        with timer.stage(name):
            pass
    return timer.report(), timer.as_dict(), timer.total('missing')


def test_stage_timer_report_equals_jax(monkeypatch):
    got = _timed_report(profiling, monkeypatch)
    want = _timed_report(jax_profiling, monkeypatch)
    assert got == want
    assert '(2 calls, 50%)' in got[0] and got[2] == 0.0


def test_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / 'trace')):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(str(tmp_path / 'trace' / 'trace.json')) as f:
        assert json.load(f)['traceEvents']
    with profiling.trace(None):    # No directory: nothing is traced.
        pass
