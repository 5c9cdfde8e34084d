"""Share of the traced slice's ``Decoder.infer_pair`` calls that replayed
a resident push plan: the program's counter ``decoder.graph_replays``
over its ``decoder.infer_pair`` spans. A program without the counter
(``utils/profiling.py`` naming no ``GRAPH_REPLAYS``) reads nothing."""

from portbench.harness import spans


def read(readings):
    found = spans.read(readings, 'serve')
    calls = 0 if found is None else found.count('decoder.infer_pair')
    if not calls:
        return None
    from telluride_decoding_torch.utils import profiling
    counter = getattr(profiling, 'GRAPH_REPLAYS', None)
    if counter is None:
        return None
    return found.counters.get(counter, 0) / calls
