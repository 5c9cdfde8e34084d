"""Mean host ms a push in the program's ``decoder.towers`` span: the
towers launched eagerly, outside a push plan's graph; 0.0 where the
slice holds no such span (every push replayed a plan). A program
without the span (``utils/profiling.py`` naming no ``TOWER_PASSES``,
which came with it) reads nothing."""

from portbench.harness import spans


def read(readings):
    if readings.get('model') != 'dcca':
        return None
    found = spans.read(readings, 'serve')
    pushes = 0 if found is None else found.count('serve.push')
    if not pushes:
        return None
    from telluride_decoding_torch.utils import profiling
    if getattr(profiling, 'TOWER_PASSES', None) is None:
        return None
    return found.ms('decoder.towers', pushes) or 0.0
