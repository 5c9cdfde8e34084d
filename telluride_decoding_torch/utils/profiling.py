"""Per-stage timing, spans and counters, and device traces (port of
utils/profiling.py).

StageTimer is the JAX package's host timer, copied: named-stage
wall-clock sums with a one-line-per-stage report, used by the experiment
driver. ``trace`` writes a ``torch.profiler`` Chrome trace of a block,
the counterpart of the JAX package's ``jax.profiler`` trace.
``timed_block`` times one block, copied too; on the card pass
``torch.cuda.synchronize`` as ``sync`` (as a JAX caller passes a
``block_until_ready``), or queued kernels go untimed.

The port's one span and counter recorder: ``span(name, request)`` around
a piece of host work, ``count(name, n)`` (``host_wait`` for the counter
``host_waits``, each place the host blocks on the card; ``GRAPH_REPLAYS``
and ``GRAPH_CAPTURES`` for the decoder's resident push plans,
decode/push_plan.py, and ``DEVICE_STACKS`` for decoder calls that
stack raw context windows on the card; ``TOWER_PASSES`` for a deep CCA
decoder's tower passes and ``FUSED_TOWER_PASSES`` for those that ran
kernel T1; ``PREDICT_PASSES`` for a regression decoder's forward
passes and ``FUSED_PREDICT_PASSES`` for those that ran kernel R1;
``WINDOW_FRAMES`` for the raw frames a window model's passes read),
``recorded()`` and ``reset()``. It records while a
torch profiler runs, and only then: ``torch.profiler.profile`` (the
benchmark's traced slice) or ``trace`` (an operator's ``--trace_dir``).
Off, a span costs one read of torch's own flag and hands back a shared
no-op. On, each span keeps (name,
start_ns, end_ns, parent, request) in memory, ``parent`` the index of
the enclosing span (-1 at the top) and ``request`` the push or sweep it
belongs to (inherited from the parent when not given); past ``CAP``
events the counter ``dropped`` grows instead. Times are ``time.time_ns``:
CLOCK_REALTIME, the clock Kineto stamps the profiler's host and device
events with, so a span lies on the profile's own timeline. Inside
``trace`` each span also opens ``record_function``, so the spans are
drawn over the kernels in trace.json. Spans never synchronise: a
StageTimer stage, which is also recorded as a span, waits only on the
``sync`` its caller passes.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _autograd_profiler

HOST_WAITS = 'host_waits'
# Pushes served by replaying a resident plan's CUDA graph, and captures.
GRAPH_REPLAYS = 'decoder.graph_replays'
GRAPH_CAPTURES = 'decoder.graph_captures'
# A deep CCA decoder's tower passes served (one a stream: 3 a pair), eager
# or inside a push plan's graph.
TOWER_PASSES = 'decoder.tower_passes'
# Those of them that ran kernel T1 (ops/dcca_towers.py), replays included.
FUSED_TOWER_PASSES = 'decoder.fused_tower_passes'
# Decoder calls whose raw context windows were lag-stacked on the card
# (one a call, with or without a push plan).
DEVICE_STACKS = 'decoder.device_stacks'
# The model's forward passes in a served call without kernel K1 (one a
# call where the prediction reads input_1 alone, else one a stream), eager
# or inside a push plan's graph.
PREDICT_PASSES = 'decoder.predict_passes'
# Those of them that ran kernel R1 (ops/regression_push.py), replays
# included.
FUSED_PREDICT_PASSES = 'decoder.fused_predict_passes'
# The raw frames that the forward passes of a model with a window context
# (``BrainModel.window_context``: VLAAI) read in served calls, its rows
# and their context, replays included.
WINDOW_FRAMES = 'decoder.window_frames'
DROPPED = 'dropped'
CAP = 1 << 20
_clock = time.time_ns
# Whether a profiler runs: torch's own flag, ``_is_profiler_enabled`` in
# torch.autograd.profiler, kept "to reduce latency" of exactly this check
# (read with getattr: tests/test_torch_profiling.py pins it).


class Event(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]      # None while the span is open.
    parent: int                # Index of the enclosing span, -1 at the top.
    request: Optional[int]


class Recorded(NamedTuple):
    events: List[Event]
    counters: Dict[str, int]


class SpanTotal(NamedTuple):
    count: int
    total_ns: int
    self_ns: int               # Less the time its child spans cover.


class _Off:
    """The shared span of a run without a profiler."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ('_recorder', '_name', '_request', '_event', '_index',
                 '_annotation')

    def __init__(self, recorder: 'Recorder', name: str,
                 request: Optional[int]):
        self._recorder = recorder
        self._name = name
        self._request = request
        self._event = None
        self._annotation = None

    def __enter__(self):
        recorder = self._recorder
        events = recorder._events
        if len(events) >= recorder.cap:
            recorder._counters[DROPPED] += 1
            return self
        stack = recorder._stack()
        parent = stack[-1] if stack and stack[-1] < len(events) else -1
        request = self._request
        if request is None and parent >= 0:
            request = events[parent][4]
        if recorder.annotate:
            from torch.profiler import record_function
            self._annotation = record_function(self._name)
            self._annotation.__enter__()
        self._index = len(events)
        self._event = [self._name, _clock(), None, parent, request]
        events.append(self._event)
        stack.append(self._index)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._event is not None:
            self._event[2] = _clock()
            stack = self._recorder._stack()
            if stack and stack[-1] == self._index:
                stack.pop()
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
        return False


class Recorder:
    """Spans and counters in memory, up to ``cap`` spans."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.annotate = False   # Also record_function (inside trace()).
        self._local = threading.local()
        self.reset()

    def _stack(self) -> list:
        stack = getattr(self._local, 'stack', None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def reset(self):
        """Forgets every span and counter; call it outside any span."""
        self._events: list = []
        self._counters: Dict[str, int] = collections.defaultdict(int)
        self._local.stack = []

    def span(self, name: str, request: Optional[int] = None) -> _Span:
        return _Span(self, name, request)

    def count(self, name: str, n: int = 1):
        self._counters[name] += n

    def recorded(self) -> Recorded:
        return Recorded([Event(*e) for e in self._events],
                        dict(self._counters))


RECORDER = Recorder()


def span(name: str, request: Optional[int] = None):
    """A context manager around host work: a span while a profiler runs,
    else a shared no-op. ``request``: the push or sweep index (default:
    the enclosing span's)."""
    if not getattr(_autograd_profiler, '_is_profiler_enabled', False):
        return _OFF
    return RECORDER.span(name, request)


def count(name: str, n: int = 1):
    """Adds ``n`` to counter ``name`` while a profiler runs."""
    if getattr(_autograd_profiler, '_is_profiler_enabled', False):
        RECORDER.count(name, n)


def host_wait(device, n: int = 1):
    """Counts ``n`` blocking waits of the host on ``device`` (a blocking
    copy in from pageable memory, a read back, an event or device
    synchronize) in ``host_waits``, when ``device`` is a CUDA device."""
    if (getattr(_autograd_profiler, '_is_profiler_enabled', False)
            and device.type == 'cuda'):
        RECORDER.count(HOST_WAITS, n)


def recorded() -> Recorded:
    """The spans and counters recorded so far."""
    return RECORDER.recorded()


def reset():
    RECORDER.reset()


def span_totals(events: List[Event]) -> Dict[str, SpanTotal]:
    """Per span name: how many closed spans, their summed duration and
    their self time (each span less the parts its child spans cover)."""
    children_ns = [0] * len(events)
    for event in events:
        if event.end_ns is not None and event.parent >= 0:
            children_ns[event.parent] += event.end_ns - event.start_ns
    totals: Dict[str, list] = {}
    for event, inner in zip(events, children_ns):
        if event.end_ns is None:
            continue
        entry = totals.setdefault(event.name, [0, 0, 0])
        entry[0] += 1
        entry[1] += event.end_ns - event.start_ns
        entry[2] += event.end_ns - event.start_ns - inner
    return {name: SpanTotal(*v) for name, v in totals.items()}


class StageTimer:
    """Accumulates wall-clock per named stage across repeated calls; each
    stage is also a span (named ``span_name``, default the stage's)."""

    def __init__(self, name: str = 'pipeline'):
        self.name = name
        self._totals: Dict[str, float] = collections.defaultdict(float)
        self._counts: Dict[str, int] = collections.defaultdict(int)
        self._order = []

    @contextlib.contextmanager
    def stage(self, stage_name: str,
              sync: Optional[Callable[[], None]] = None,
              span_name: Optional[str] = None,
              request: Optional[int] = None):
        with span(span_name or stage_name, request):
            start = time.perf_counter()
            try:
                yield
            finally:
                if sync is not None:
                    sync()
                elapsed = time.perf_counter() - start
                if stage_name not in self._totals:
                    self._order.append(stage_name)
                self._totals[stage_name] += elapsed
                self._counts[stage_name] += 1

    def total(self, stage_name: str) -> float:
        # .get, not [ ]: indexing a defaultdict would insert a phantom
        # 0.0 entry that later hides the stage from report()'s order.
        return self._totals.get(stage_name, 0.0)

    def report(self) -> str:
        lines = ['%s timing:' % self.name]
        grand = sum(self._totals.values())
        for stage_name in self._order:
            total = self._totals[stage_name]
            count = self._counts[stage_name]
            lines.append('  %-24s %8.1f ms  (%d call%s, %.0f%%)' %
                         (stage_name, total * 1000, count,
                          's' if count != 1 else '',
                          100 * total / grand if grand else 0))
        lines.append('  %-24s %8.1f ms' % ('TOTAL', grand * 1000))
        return '\n'.join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self._totals)


@contextlib.contextmanager
def trace(log_dir: Optional[str], cuda: bool = False):
    """A torch.profiler trace of the block, written to
    ``log_dir/trace.json`` (chrome://tracing, Perfetto); the card's
    activity too when ``cuda``. The recorder's spans are drawn in it as
    ``record_function`` ranges. No-op when log_dir is empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    annotate = RECORDER.annotate
    RECORDER.annotate = True
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        RECORDER.annotate = annotate
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


@contextlib.contextmanager
def timed_block(label: str, results: Optional[Dict[str, float]] = None,
                sync: Optional[Callable[[], None]] = None,
                verbose: bool = False):
    """Wall-clock seconds of the block, ``sync`` called before the clock
    stops; stored as ``results[label]`` and printed in ms if
    ``verbose``."""
    start = time.perf_counter()
    yield
    if sync is not None:
        sync()
    elapsed = time.perf_counter() - start
    if results is not None:
        results[label] = elapsed
    if verbose:
        print('%s: %.1f ms' % (label, elapsed * 1000))
