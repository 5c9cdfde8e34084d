"""Share of a VLAAI serving window's traced slice, in %, in which the
card ran no kernel or copy, as device.idle_share.serve reads it: 1 -
busy / window, busy the union of the profiler's device events."""


def read(readings):
    if readings.get('model') != 'vlaai' or 'trace' not in readings:
        return None
    traced = readings['trace']
    return 100.0 * (1.0 - traced['busy_s'] / traced['window_s'])
