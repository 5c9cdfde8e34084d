"""The program's own spans and counters of a traced run
(``telluride_decoding_torch.utils.profiling.recorded()``), for the
per-layer readers.

The recorder records while a torch profiler runs, so what it holds after
a traced run is the traced slice of the window (harness/trace.py's
``Slice``) and nothing of the warm-up. An untraced run, or a program
without the recorder, gives None.
"""

from __future__ import annotations

from typing import Optional


class Spans:
    """Totals by span name, the counters, and the slice's requests."""

    def __init__(self, recorded):
        from telluride_decoding_torch.utils import profiling
        self.totals = profiling.span_totals(recorded.events)
        self.counters = recorded.counters
        self.requests = {e.request for e in recorded.events
                         if e.request is not None}

    def count(self, name: str) -> int:
        found = self.totals.get(name)
        return found.count if found else 0

    def ms(self, name: str, per: int, own: bool = False) -> Optional[float]:
        """The spans' summed (or self) time in ms over ``per``; None
        where either is missing."""
        found = self.totals.get(name)
        if found is None or not per:
            return None
        return (found.self_ns if own else found.total_ns) / per / 1e6


def read(readings: dict, kind: str) -> Optional[Spans]:
    """The traced slice's spans of a run of ``kind``, or None."""
    if readings.get('kind') != kind or 'trace' not in readings:
        return None
    try:
        from telluride_decoding_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, 'recorded', None)
    if recorded is None:
        return None
    found = recorded()
    return Spans(found) if found.events else None


def per_push(readings: dict, name: str, own: bool = False):
    """ms a push of span ``name``, over the slice's ``serve.push``
    spans."""
    spans = read(readings, 'serve')
    return None if spans is None else spans.ms(
        name, spans.count('serve.push'), own)


def per_sweep(readings: dict, name: str):
    """ms a sweep of span ``name``, over the slice's distinct sweeps."""
    spans = read(readings, 'sweep')
    return None if spans is None else spans.ms(name, len(spans.requests))
