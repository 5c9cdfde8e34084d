"""The program's counter ``host_waits`` a push in a DNN serving window,
as serve.host_waits reads it: the times the host blocks on the card
(blocking copies in and out, event waits), over the traced slice's
``serve.push`` spans. A cell of its own, since the DNN cell reports the
push's latency and not its frames a second."""

from portbench.harness import spans


def read(readings):
    if readings.get('model') != 'dnn':
        return None
    found = spans.read(readings, 'serve')
    pushes = 0 if found is None else found.count('serve.push')
    if not pushes:
        return None
    return found.counters.get('host_waits', 0) / pushes
