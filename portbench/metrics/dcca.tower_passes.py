"""The program's counter ``decoder.tower_passes`` a push: tower passes
served (eager or inside a push plan's graph), over the traced slice's
``serve.push`` spans; 3 a deep CCA push. A program without the counter
(``utils/profiling.py`` naming no ``TOWER_PASSES``) reads nothing."""

from portbench.harness import spans


def read(readings):
    if readings.get('model') != 'dcca':
        return None
    found = spans.read(readings, 'serve')
    pushes = 0 if found is None else found.count('serve.push')
    if not pushes:
        return None
    from telluride_decoding_torch.utils import profiling
    counter = getattr(profiling, 'TOWER_PASSES', None)
    if counter is None:
        return None
    return found.counters.get(counter, 0) / pushes
