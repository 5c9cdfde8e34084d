"""The program's counter ``decoder.predict_passes`` a push: the
regressor's forward passes served (eager or inside a push plan's graph),
over the traced slice's ``serve.push`` spans; 1 a push where one
prediction serves both talkers. A program without the counter
(``utils/profiling.py`` naming no ``PREDICT_PASSES``) reads nothing."""

from portbench.harness import spans


def read(readings):
    if readings.get('model') != 'dnn':
        return None
    found = spans.read(readings, 'serve')
    pushes = 0 if found is None else found.count('serve.push')
    if not pushes:
        return None
    from telluride_decoding_torch.utils import profiling
    counter = getattr(profiling, 'PREDICT_PASSES', None)
    if counter is None:
        return None
    return found.counters.get(counter, 0) / pushes
