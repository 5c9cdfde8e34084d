"""The device trace of a measured window: torch.profiler over its first
seconds (CUDA activity only), reduced to the card's busy seconds, each
kernel's seconds and launches, and the breakdown's top device operations
and idle gaps.

The split of device events into kernels and copies, and the sums by
kernel name, are chip_smoke.py's ``device_busy`` and ``device_ms``,
applied to one profile of the whole window instead of repeated calls.
"""

from __future__ import annotations

import collections

TOP = 10
# The traced slice of a window: long enough for some tens of sweeps or
# thousands of pushes, short enough that the trace reads in seconds.
SECONDS = 5.0
NAME_CHARS = 80


class Slice:
    """torch.profiler over the first ``seconds`` of a measured window
    (the card's activity; the host's on a CPU device, which has none of
    the card's), so that a traced run and the reading of its trace stay
    short at any window length. Start it before the window; ``tick`` at
    each step's end stops it once the slice has passed."""

    def __init__(self, enabled: bool, device, seconds: float):
        self.prof = None
        self.window_s = None
        self._seconds = seconds
        if enabled:
            from torch.profiler import ProfilerActivity, profile
            activity = (ProfilerActivity.CUDA if device.type == 'cuda'
                        else ProfilerActivity.CPU)
            self.prof = profile(activities=[activity])
            self.prof.start()

    def tick(self, elapsed: float, last: bool = False):
        """Stops the profiler after the step that ends ``elapsed``
        seconds into the window, if the slice has passed or the window
        ends."""
        if self.prof is not None and self.window_s is None and (
                elapsed >= self._seconds or last):
            self.prof.stop()
            self.window_s = elapsed

    def reduce(self):
        return None if self.prof is None else reduce(self.prof,
                                                     self.window_s)


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + '...'


def reduce(prof, window_s: float) -> dict:
    """{'window_s', 'busy_s', 'kernels': {name: [seconds, launches]},
    'device_ops', 'idle_gaps'} of a profile of ``window_s`` seconds.
    ``busy_s`` is the union of the device events' intervals;
    ``idle_gaps`` sums the gaps between consecutive device events by the
    pair of operations around them."""
    from torch.autograd import DeviceType
    spans = []
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for event in prof.events():
        if event.device_type != DeviceType.CUDA:
            continue
        start = event.time_range.start
        end = event.time_range.end
        spans.append((start, end, event.name))
        entry = kernels[event.name]
        entry[0] += (end - start) / 1e6
        entry[1] += 1
    spans.sort()
    busy_us = 0.0
    gaps = collections.defaultdict(float)
    reach, last = None, None
    for start, end, name in spans:
        if reach is None or start >= reach:
            if reach is not None:
                gaps['%s -> %s' % (_short(last), _short(name))] += (
                    start - reach) / 1e6
            busy_us += end - start
            reach, last = end, name
        elif end > reach:
            busy_us += end - reach
            reach, last = end, name
    ops = sorted(((k, v[0]) for k, v in kernels.items()),
                 key=lambda kv: -kv[1])
    return {'window_s': window_s, 'busy_s': busy_us / 1e6,
            'kernels': {k: list(v) for k, v in kernels.items()},
            'device_ops': [[_short(k), s] for k, s in ops[:TOP]],
            'idle_gaps': [[k, s] for k, s in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:TOP]]}


def kernel(readings: dict, symbol: str):
    """(seconds, launches) of the kernels whose name holds ``symbol`` in
    a traced run's readings; None when the trace saw none."""
    kernels = readings.get('trace', {}).get('kernels', {})
    seconds = sum(v[0] for k, v in kernels.items() if symbol in k)
    launches = sum(v[1] for k, v in kernels.items() if symbol in k)
    return (seconds, launches) if launches else None
