"""The port's span and counter recorder (utils/profiling.py) and the spans
of the serving push and the lambda sweep.

The file imports neither JAX nor the JAX package, so its card tests
(marked cuda, skipped without a card) also run on a machine without JAX:

  python -m pytest --noconftest tests/test_torch_profiling.py -m cuda

On the card they hold the counter ``host_waits`` to what
``torch.cuda.set_sync_debug_mode('warn')`` reports (every blocking copy
and read back warns) plus the explicit event and device synchronisations
(which do not warn), and check that spans, host events and device events
share one timeline.
"""

import collections
import json
import os
import time
import warnings

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from telluride_decoding_torch.cli import serve
from telluride_decoding_torch.decode.infer_decoder import (
    CCADecoder, CorrelationParamsTuple, ModelParamsTuple)
from telluride_decoding_torch.models.cca import BrainModelCCA
from telluride_decoding_torch.solvers.lda import LdaParams
from telluride_decoding_torch.sweep import engine
from telluride_decoding_torch.utils import profiling

CPU = torch.device('cpu')
SERVE_TREE = {'serve.push': {'serve.context', 'decoder.infer_pair',
                             'serve.store'},
              'decoder.infer_pair': {'decoder.copy_in', 'decoder.launch',
                                     'decoder.copy_out'},
              'serve.store': {'decide.window'}}


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from telluride_decoding_torch.device import cuda_device
    return cuda_device()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def children(events, index):
    return [e for e in events if e.parent == index]


def test_nothing_recorded_without_a_profiler():
    off = profiling.span('a', 3)
    assert off is profiling.span('b')      # The shared no-op.
    with profiling.span('a', 3):
        with profiling.span('b'):
            profiling.count('c', 2)
            profiling.host_wait(torch.device('cuda'))
    assert profiling.recorded() == ([], {})


def test_profiler_flag_is_pinned():
    """The recorder reads torch's own flag; a torch without it fails
    here instead of recording nothing."""
    assert autograd_profiler._is_profiler_enabled is False
    with cpu_profile():
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False


def test_nested_spans_record_parent_and_request():
    with cpu_profile():
        with profiling.span('push', 7):
            with profiling.span('inner'):
                with profiling.span('leaf'):
                    pass
            with profiling.span('other'):
                pass
        with profiling.span('push', 8):
            pass
        with profiling.span('loose'):
            pass
    events = profiling.recorded().events
    assert [(e.name, e.parent, e.request) for e in events] == [
        ('push', -1, 7), ('inner', 0, 7), ('leaf', 1, 7), ('other', 0, 7),
        ('push', -1, 8), ('loose', -1, None)]
    for e in events:
        assert e.start_ns <= e.end_ns
        if e.parent >= 0:
            outer = events[e.parent]
            assert outer.start_ns <= e.start_ns <= e.end_ns <= outer.end_ns


def test_self_time_is_the_span_less_its_children():
    events = [profiling.Event('p', 0, 100, -1, 0),
              profiling.Event('c', 10, 30, 0, 0),
              profiling.Event('g', 12, 20, 1, 0),
              profiling.Event('c', 40, 70, 0, 0),
              profiling.Event('open', 80, None, 0, 0)]
    totals = profiling.span_totals(events)
    assert totals['p'] == (1, 100, 50)
    assert totals['c'] == (2, 50, 42)
    assert totals['g'] == (1, 8, 8)
    assert 'open' not in totals
    with cpu_profile():
        with profiling.span('p'):
            with profiling.span('c'):
                time.sleep(0.002)
            time.sleep(0.002)
    recorded = profiling.recorded().events
    p, c = profiling.span_totals(recorded)['p'], recorded[1]
    assert p.self_ns == p.total_ns - (c.end_ns - c.start_ns)
    assert p.self_ns >= 2e6


def test_counters_add_up():
    with cpu_profile():
        profiling.count('x')
        profiling.count('x', 4)
        profiling.host_wait(CPU)                    # No card: no wait.
        profiling.host_wait(torch.device('cuda'), 2)
        profiling.host_wait(torch.device('cuda', 0))
    assert profiling.recorded().counters == {'x': 5, 'host_waits': 3}


def test_past_the_cap_events_are_dropped(monkeypatch):
    monkeypatch.setattr(profiling.RECORDER, 'cap', 3)
    with cpu_profile():
        for _ in range(5):
            with profiling.span('s'):
                pass
    recorded = profiling.recorded()
    assert len(recorded.events) == 3
    assert recorded.counters == {'dropped': 2}


def test_reset_clears_events_and_counters():
    with cpu_profile():
        with profiling.span('s'):
            profiling.count('x')
    assert profiling.recorded().events
    profiling.reset()
    assert profiling.recorded() == ([], {})


def _timer_report(monkeypatch):
    ticks = iter(np.arange(0.0, 10.0, 0.125))
    with monkeypatch.context() as patch:
        patch.setattr(time, 'perf_counter', lambda: float(next(ticks)))
        timer = profiling.StageTimer('sweep')
        calls = []
        with timer.stage('moments', sync=lambda: calls.append(1),
                         span_name='sweep.moments', request=4):
            pass
        for _ in range(2):
            with timer.stage('grid'):
                pass
    return timer.report(), timer.as_dict(), calls


def test_stage_timer_stages_are_spans(monkeypatch):
    with cpu_profile():
        traced = _timer_report(monkeypatch)
    assert traced == _timer_report(monkeypatch)
    assert traced[2] == [1] and '(2 calls, 67%)' in traced[0]
    events = profiling.recorded().events
    assert [(e.name, e.request) for e in events] == [
        ('sweep.moments', 4), ('grid', None), ('grid', None)]


def test_span_lies_on_the_profilers_clock():
    """A span's interval contains the profiler's own event for an aten
    op run inside it: both are stamped on one timeline."""
    x = torch.ones((256, 256))
    with cpu_profile() as prof:
        with profiling.span('outer'):
            time.sleep(0.001)
            x @ x
            time.sleep(0.001)
    (outer,) = profiling.recorded().events
    (mm,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == 'aten::mm']
    assert outer.start_ns <= mm.start_ns() <= mm.end_ns() <= outer.end_ns


def test_spans_annotate_only_inside_trace(tmp_path):
    with cpu_profile() as prof:
        with profiling.span('not.drawn'):
            torch.ones(3) + 1
    assert 'not.drawn' not in {e.name for e in prof.events()}
    with profiling.trace(str(tmp_path)):
        with profiling.span('drawn'):
            torch.ones(3) + 1
    with open(str(tmp_path / 'trace.json')) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert 'drawn' in names
    assert profiling.RECORDER.annotate is False


def make_decoder(device, eeg_channels=4, post=3, dims=3):
    """A CCA decoder with the LDA reduction (K1 on the card, its plain
    version on the CPU) from seeded weights."""
    rng = np.random.RandomState(0)
    f1, f2 = eeg_channels * (post + 1), 3
    model = BrainModelCCA.from_numpy(
        {'mean1': 0.1 * rng.randn(1, f1), 'mean2': 0.1 * rng.randn(1, f2),
         'rot1': rng.randn(f1, dims) / f1, 'rot2': rng.randn(f2, dims)},
        device)
    decoder = CCADecoder(model, reduction='lda', device=device)
    decoder.decoding_model_params = {
        'pre_context': 0, 'post_context': post, 'input2_pre_context': 1,
        'input2_post_context': 1}
    zeros = np.zeros(dims)
    decoder.model_params = ModelParamsTuple(
        CorrelationParamsTuple(1, zeros, zeros, zeros, zeros,
                               0.1 * rng.randn(dims), 0.1 * rng.randn(dims),
                               1.0 + rng.rand(dims)),
        LdaParams(rng.randn(dims, 1), np.zeros((dims, 1)), np.array([0, 1]),
                  np.zeros((2, dims)), 0.1, 0.5))
    return decoder


def make_server(device, decision='wta', pipeline=False, chunk=8):
    server = serve.StreamingAttentionServer(
        make_decoder(device), eeg_channels=4, window_width=16,
        window_step=8, decision=decision, frame_rate=32.0,
        pipeline=pipeline)
    rng = np.random.RandomState(1)

    def push():
        return server.push(rng.randn(chunk, 4), rng.rand(chunk, 1),
                           rng.rand(chunk, 1))
    return server, push


@pytest.mark.parametrize('pipeline', [False, True])
def test_push_records_its_span_tree(pipeline):
    server, push = make_server(CPU, pipeline=pipeline)
    for _ in range(4):
        push()
    first = server._pushes
    with cpu_profile():
        decided = sum(len(push()) for _ in range(6))
    events = profiling.recorded().events
    pushes = [e for e in events if e.name == 'serve.push']
    assert [e.request for e in pushes] == list(range(first, first + 6))
    assert {e.name for e in events if e.parent == -1} == {'serve.push'}
    for index, event in enumerate(events):
        below = {c.name for c in children(events, index)}
        want = SERVE_TREE.get(event.name, set())
        if event.name == 'serve.store' and not below:
            continue                 # No window due in this push.
        assert below == want, (event.name, below)
        root = event
        while root.parent >= 0:
            root = events[root.parent]
        assert event.request == root.request
    counts = collections.Counter(e.name for e in events)
    assert counts['decide.window'] == decided > 0
    for name in ('serve.context', 'serve.store', 'decoder.infer_pair',
                 'decoder.copy_in', 'decoder.launch', 'decoder.copy_out'):
        assert counts[name] == 6, name
    # Outside a profiler the server records nothing.
    profiling.reset()
    push()
    assert profiling.recorded() == ([], {})


def small_sweep_inputs(files=4, frames=120, channels=3):
    rng = np.random.RandomState(2)
    ctx = engine.ContextSpec(0, 2, 1, 1)
    xs = [rng.randn(frames + ctx.x_post, channels).astype(np.float32)
          for _ in range(files)]
    ys = [rng.randn(frames + ctx.y_post, 1).astype(np.float32)
          for _ in range(files)]
    return xs, ys, ctx


@pytest.mark.parametrize('model', ['ridge', 'cca'])
@pytest.mark.parametrize('explicit_chunk', [None, '2'])
def test_sweep_records_each_lambda_chunk(monkeypatch, model,
                                         explicit_chunk):
    if explicit_chunk is None:
        monkeypatch.delenv('TDT_SWEEP_LAM_CHUNK', raising=False)
    else:
        monkeypatch.setenv('TDT_SWEEP_LAM_CHUNK', explicit_chunk)
    xs, ys, ctx = small_sweep_inputs()
    lambdas = [1e-3, 1e-2, 1e-1, 1.0, 10.0]
    sweep = (engine.ridge_jackknife_sweep if model == 'ridge' else
             engine.cca_jackknife_sweep)
    with cpu_profile():
        sweep(xs, ys, lambdas, context=ctx, device='cpu')
        sweep(xs, ys, lambdas, context=ctx, device='cpu',
              timer=profiling.StageTimer('t'))
    events = profiling.recorded().events
    dx, dy = ctx.stacked_widths(3, 1)
    square = (dx + 1) ** 2 if model == 'ridge' else dx * dx + dy * dy
    chunk = engine._lam_chunk_units(len(xs), square, len(lambdas))
    requests = sorted({e.request for e in events})
    assert len(requests) == 2
    for request in requests:
        mine = [e for e in events if e.request == request]
        names = collections.Counter(e.name for e in mine)
        assert names['sweep.lam_chunk'] == -(-len(lambdas) // chunk)
        assert names['sweep.moments'] == names['sweep.grid'] == 1
        assert names['sweep.readback'] == 1 and names['sweep.upload'] >= 2
        for e in mine:
            parent = events[e.parent].name if e.parent >= 0 else None
            want = {'sweep.upload': 'sweep.moments',
                    'sweep.lam_chunk': 'sweep.grid'}.get(e.name)
            assert parent == want, (e.name, parent)


def test_serve_trace_dir_draws_the_push(tmp_path):
    """``cli.serve --trace_dir`` replays under profiling.trace: the file
    holds each push's spans."""
    model_dir = str(tmp_path / 'model')
    decoder = make_decoder(CPU)
    decoder.decoding_model.add_metadata({
        'pre_context': 0, 'post_context': 3, 'input2_pre_context': 1,
        'input2_post_context': 1, 'dnn_regressor': 'cca'})
    decoder.decoding_model.save(model_dir)
    decoder.save_parameters(os.path.join(model_dir, 'decoder_model.json'))
    rng = np.random.RandomState(3)
    stream = str(tmp_path / 'stream.npz')
    np.savez(stream, eeg=rng.randn(256, 4).astype(np.float32),
             audio1=rng.rand(256, 1).astype(np.float32),
             audio2=rng.rand(256, 1).astype(np.float32))
    trace_dir = str(tmp_path / 'trace')
    assert serve.main(['--serve_model_dir', model_dir, '--serve_input',
                       stream, '--serve_output', str(tmp_path / 'out'),
                       '--serve_device', 'cpu', '--chunk_size', '32',
                       '--trace_dir', trace_dir]) == 0
    with open(os.path.join(trace_dir, 'trace.json')) as f:
        names = collections.Counter(
            e.get('name') for e in json.load(f)['traceEvents'])
    assert names['serve.push'] == 256 // 32
    assert names['decoder.launch'] == 256 // 32


# -- on the card -------------------------------------------------------------


class SyncCount:
    """While active: warnings of torch.cuda.set_sync_debug_mode('warn')
    and calls of Event.synchronize and torch.cuda.synchronize, by site.
    A warning raised inside torch.cuda.synchronize itself (some torch
    versions warn there) is that call's, counted once."""

    def __init__(self, monkeypatch):
        self.sites = collections.Counter()
        self._active = False
        event_sync = torch.cuda.Event.synchronize
        device_sync = torch.cuda.synchronize

        def counted_event_sync(event):
            if self._active:
                self.sites['Event.synchronize'] += 1
            return event_sync(event)

        def counted_device_sync(*args, **kwargs):
            if self._active:
                self.sites['torch.cuda.synchronize'] += 1
            return device_sync(*args, **kwargs)
        monkeypatch.setattr(torch.cuda.Event, 'synchronize',
                            counted_event_sync)
        monkeypatch.setattr(torch.cuda, 'synchronize', counted_device_sync)

    def __enter__(self):
        self._catch = warnings.catch_warnings(record=True)
        self._caught = self._catch.__enter__()
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        self._active = True
        return self

    def __exit__(self, *exc):
        self._active = False
        torch.cuda.set_sync_debug_mode('default')
        self._catch.__exit__(*exc)
        inside_synchronize = os.path.join('torch', 'cuda', '__init__.py')
        for w in self._caught:
            if ('synchronizing' in str(w.message) and
                    not w.filename.endswith(inside_synchronize)):
                self.sites['%s:%d' % (os.path.relpath(w.filename),
                                      w.lineno)] += 1
        return False

    @property
    def total(self) -> int:
        return sum(self.sites.values())


@pytest.mark.cuda
@pytest.mark.parametrize('decision,pipeline', [('wta', False),
                                               ('stepped', False),
                                               ('ssd', False),
                                               ('wta', True)])
def test_host_waits_of_a_push_are_its_syncs(cuda, monkeypatch, decision,
                                            pipeline):
    server, push = make_server(cuda, decision, pipeline, chunk=8)
    for _ in range(40):                    # Past the ssd warm-up.
        push()
    torch.cuda.synchronize()
    syncs = SyncCount(monkeypatch)
    with profile(activities=[ProfilerActivity.CUDA]), syncs:
        decided = push()
    assert decided                         # A window every push.
    waits = profiling.recorded().counters.get('host_waits', 0)
    assert waits == syncs.total, syncs.sites
    # The decoder's push plan waits once (S1 once more); the pipelined
    # push keeps three copies in and two reads.
    assert waits == {('ssd', False): 2, ('wta', True): 5}.get(
        (decision, pipeline), 1), syncs.sites


@pytest.mark.cuda
@pytest.mark.parametrize('model', ['ridge', 'cca'])
def test_host_waits_of_a_sweep_are_its_syncs(cuda, monkeypatch, model):
    xs, ys, ctx = small_sweep_inputs(files=6, frames=400, channels=8)
    sweep = (engine.ridge_jackknife_sweep if model == 'ridge' else
             engine.cca_jackknife_sweep)
    lambdas = [1e-3, 1e-2, 1e-1, 1.0]
    sweep(xs, ys, lambdas, context=ctx, device=cuda)
    torch.cuda.synchronize()
    syncs = SyncCount(monkeypatch)
    with profile(activities=[ProfilerActivity.CUDA]), syncs:
        sweep(xs, ys, lambdas, context=ctx, device=cuda,
              timer=profiling.StageTimer('t'))
    recorded = profiling.recorded()
    waits = recorded.counters.get('host_waits', 0)
    assert waits == syncs.total, syncs.sites
    # The lambda vector, the stacks of x and y and their masks, one count
    # a file's moments block, the timer's two synchronizes, the read back;
    # and two reads a CCA lambda chunk's SVD.
    chunks = sum(e.name == 'sweep.lam_chunk' for e in recorded.events)
    assert waits == 1 + 4 + len(xs) + 2 + 1 + (
        2 * chunks if model == 'cca' else 0), syncs.sites


@pytest.mark.cuda
def test_span_lies_on_the_device_clock(cuda):
    """A span that ends in a synchronize contains the device interval of
    the kernel launched inside it, and the launch's runtime call."""
    x = torch.randn((2048, 2048), device=cuda)
    x @ x
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with profiling.span('outer'):
            time.sleep(0.001)
            x @ x
            torch.cuda.synchronize()
    (outer,) = profiling.recorded().events
    # The profile's events count microseconds from its start.
    base_ns = prof.profiler.kineto_results.trace_start_ns()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert kernels
    for kernel in kernels:
        start = base_ns + kernel.time_range.start * 1000
        end = base_ns + kernel.time_range.end * 1000
        assert outer.start_ns <= start <= end <= outer.end_ns, (
            kernel.name, outer, start, end)


@pytest.mark.cuda
def test_trace_draws_the_launch_and_copies_in_their_spans(cuda, tmp_path):
    """A push on the decoder's plan: the graph's launch call lies in
    ``decoder.launch``, and its copy in, K1 and copy out on the card
    between that span's start and the end of the push's
    ``decoder.copy_out``."""
    server, push = make_server(cuda, chunk=8)
    for _ in range(8):
        push()
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path), cuda=True):
        for _ in range(4):
            push()
    with open(str(tmp_path / 'trace.json')) as f:
        events = [e for e in json.load(f)['traceEvents'] if 'dur' in e]

    def ranges(name):
        return [(e['ts'], e['ts'] + e['dur']) for e in events
                if e.get('name') == name and
                e.get('cat') != 'gpu_user_annotation']

    def inside(at, spans):
        return any(lo <= at[0] and at[1] <= hi for lo, hi in spans)
    launch, copy_out = ranges('decoder.launch'), ranges('decoder.copy_out')
    assert len(launch) == len(copy_out) == 4
    pushes = [(lo, out_hi) for (lo, _), (_, out_hi) in zip(launch, copy_out)]
    k1 = [e for e in events if e.get('cat') == 'kernel' and
          'fused_cca_decode' in e['name']]
    by_correlation = {e['args'].get('correlation'): e for e in events
                      if e.get('cat') in ('cuda_runtime', 'cuda_driver')}
    assert len(k1) == 4
    for kernel in k1:
        call = by_correlation[kernel['args']['correlation']]
        assert inside((call['ts'], call['ts'] + call['dur']), launch)
        assert inside((kernel['ts'], kernel['ts'] + kernel['dur']), pushes)
    for kind in ('HtoD', 'DtoH'):
        copies = [(e['ts'], e['ts'] + e['dur']) for e in events
                  if e.get('cat') == 'gpu_memcpy' and kind in e['name']]
        assert len(copies) == 4, kind
        for copy in copies:
            assert inside(copy, pushes), (kind, copy)
