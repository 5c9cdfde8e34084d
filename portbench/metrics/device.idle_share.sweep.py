"""Share of a sweep window's traced slice, in %, in which the card
ran no kernel or copy: 1 - busy / window, busy the union of the
profiler's device events."""


def read(readings):
    if readings.get('kind') != 'sweep' or 'trace' not in readings:
        return None
    traced = readings['trace']
    return 100.0 * (1.0 - traced['busy_s'] / traced['window_s'])
