"""Raw frames the network reads a row it emits: the program's counter
``decoder.window_frames`` (the frames of every forward pass over a raw
window, replays included) over the traced slice's rows, its
``decoder.infer_pair`` spans times the window's rows a call. 9.25 where
each 32-row push recomputes its window of 32 + 264 frames; 1.0 where
each layer keeps its state between pushes. A program without the
counter (``utils/profiling.py`` naming no ``WINDOW_FRAMES``) reads
nothing."""

from portbench.harness import spans


def read(readings):
    if readings.get('model') != 'vlaai' or not readings.get('infer_calls'):
        return None
    found = spans.read(readings, 'serve')
    calls = 0 if found is None else found.count('decoder.infer_pair')
    if not calls:
        return None
    from telluride_decoding_torch.utils import profiling
    counter = getattr(profiling, 'WINDOW_FRAMES', None)
    if counter is None:
        return None
    rows = calls * readings['rows'] / readings['infer_calls']
    return found.counters.get(counter, 0) / rows
