"""The program's counter ``host_waits`` a sweep: the times the host
blocks on the card (blocking uploads, the stage synchronisations, host
reads inside the grid, the read back), over the traced slice's
sweeps."""

from portbench.harness import spans


def read(readings):
    found = spans.read(readings, 'sweep')
    if found is None or not found.requests:
        return None
    return found.counters.get('host_waits', 0) / len(found.requests)
