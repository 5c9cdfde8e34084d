"""Share of the traced slice's predictions that ran kernel R1 (the
program's fused regression kernel): its counter
``decoder.fused_predict_passes`` over ``decoder.predict_passes``; 1.0
where every served push's prediction, correlations and LDA ran as one
launch. A program without the counter (``utils/profiling.py`` naming no
``FUSED_PREDICT_PASSES``) reads nothing."""

from portbench.harness import spans


def read(readings):
    if readings.get('model') != 'dnn':
        return None
    found = spans.read(readings, 'serve')
    if found is None:
        return None
    from telluride_decoding_torch.utils import profiling
    fused = getattr(profiling, 'FUSED_PREDICT_PASSES', None)
    passes = found.counters.get(getattr(profiling, 'PREDICT_PASSES', None),
                                0)
    if fused is None or not passes:
        return None
    return found.counters.get(fused, 0) / passes
