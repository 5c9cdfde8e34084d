"""Profiler device ms of S1's window form (``ssd_window_kernel``) a
launch. S1 is latency-bound (its bytes and operations take about 1e-6
of its time), so its time, not a roofline share."""

from portbench.harness import trace


def read(readings):
    seen = trace.kernel(readings, 'ssd_window_kernel')
    if readings.get('kind') != 'serve' or seen is None:
        return None
    seconds, launches = seen
    return seconds / launches * 1e3
