"""Statistical-bound regression checks for experiment results (copy of
telluride_decoding_tpu/utils/stats_bounds.py).

Golden statistics persist as JSON, and check_within_bounds holds a fresh
result to mean +/- 4 sigma of them (the reference's sketch,
test/regression_test.py:36-43), so a quality regression in a sweep fails
loudly while ordinary run-to-run noise passes. numpy and json only.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


class BoundViolation(AssertionError):
    pass


def summarize_results(values: Sequence[float]) -> Dict[str, float]:
    values = np.asarray(values, np.float64)
    return {'mean': float(np.mean(values)),
            'std': float(np.std(values)),
            'count': int(values.size)}


def check_within_bounds(value: float, golden: Dict[str, float],
                        num_sigmas: float = 4.0,
                        label: str = 'result') -> float:
    """Asserts value is within mean +/- num_sigmas * std; returns z."""
    std = max(golden['std'], 1e-12)
    z = (value - golden['mean']) / std
    if abs(z) > num_sigmas:
        raise BoundViolation(
            '%s = %g is %.1f sigma from golden mean %g (std %g, '
            'limit %g sigma).' % (label, value, z, golden['mean'],
                                  golden['std'], num_sigmas))
    return z


class GoldenResults:
    """JSON-persisted golden statistics keyed by metric name."""

    def __init__(self, path: str):
        self._path = path
        if os.path.exists(path):
            with open(path) as f:
                self._data = json.load(f)
        else:
            self._data = {}

    def record(self, name: str, values: Sequence[float]):
        self._data[name] = summarize_results(values)
        os.makedirs(os.path.dirname(os.path.abspath(self._path)),
                    exist_ok=True)
        with open(self._path, 'w') as f:
            json.dump(self._data, f, indent=2, sort_keys=True)

    def check(self, name: str, value: float,
              num_sigmas: float = 4.0) -> Optional[float]:
        """z-score vs golden, or None (and record nothing) if no golden
        entry exists yet."""
        if name not in self._data:
            return None
        return check_within_bounds(value, self._data[name], num_sigmas,
                                   label=name)

    def names(self) -> List[str]:
        return sorted(self._data)
