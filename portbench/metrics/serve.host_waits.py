"""The program's counter ``host_waits`` a push: the times the host
blocks on the card (blocking copies in and out, event waits), over the
traced slice's ``serve.push`` spans."""

from portbench.harness import spans


def read(readings):
    found = spans.read(readings, 'serve')
    pushes = 0 if found is None else found.count('serve.push')
    if not pushes:
        return None
    return found.counters.get('host_waits', 0) / pushes
