"""Per-stage timing and device traces (port of utils/profiling.py).

StageTimer is the JAX package's host timer, copied: named-stage
wall-clock sums with a one-line-per-stage report, used by the experiment
driver. ``trace`` writes a ``torch.profiler`` Chrome trace of a block,
the counterpart of the JAX package's ``jax.profiler`` trace.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Callable, Dict, Optional


class StageTimer:
    """Accumulates wall-clock per named stage across repeated calls."""

    def __init__(self, name: str = 'pipeline'):
        self.name = name
        self._totals: Dict[str, float] = collections.defaultdict(float)
        self._counts: Dict[str, int] = collections.defaultdict(int)
        self._order = []

    @contextlib.contextmanager
    def stage(self, stage_name: str,
              sync: Optional[Callable[[], None]] = None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
            elapsed = time.perf_counter() - start
            if stage_name not in self._totals:
                self._order.append(stage_name)
            self._totals[stage_name] += elapsed
            self._counts[stage_name] += 1

    def total(self, stage_name: str) -> float:
        # .get, not [ ]: indexing a defaultdict would insert a phantom
        # 0.0 entry that later hides the stage from report()'s order.
        return self._totals.get(stage_name, 0.0)

    def report(self) -> str:
        lines = ['%s timing:' % self.name]
        grand = sum(self._totals.values())
        for stage_name in self._order:
            total = self._totals[stage_name]
            count = self._counts[stage_name]
            lines.append('  %-24s %8.1f ms  (%d call%s, %.0f%%)' %
                         (stage_name, total * 1000, count,
                          's' if count != 1 else '',
                          100 * total / grand if grand else 0))
        lines.append('  %-24s %8.1f ms' % ('TOTAL', grand * 1000))
        return '\n'.join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self._totals)


@contextlib.contextmanager
def trace(log_dir: Optional[str], cuda: bool = False):
    """A torch.profiler trace of the block, written to
    ``log_dir/trace.json`` (chrome://tracing, Perfetto); the card's
    activity too when ``cuda``. No-op when log_dir is empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
