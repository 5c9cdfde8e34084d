"""Share of the traced slice's tower passes that ran kernel T1 (the
program's fused tower kernel): its counter ``decoder.fused_tower_passes``
over ``decoder.tower_passes``; 1.0 where every served push's towers ran
as one launch. A program without the counter (``utils/profiling.py``
naming no ``FUSED_TOWER_PASSES``) reads nothing."""

from portbench.harness import spans


def read(readings):
    if readings.get('model') != 'dcca':
        return None
    found = spans.read(readings, 'serve')
    if found is None:
        return None
    from telluride_decoding_torch.utils import profiling
    fused = getattr(profiling, 'FUSED_TOWER_PASSES', None)
    passes = found.counters.get(getattr(profiling, 'TOWER_PASSES', None), 0)
    if fused is None or not passes:
        return None
    return found.counters.get(fused, 0) / passes
