"""What every kind of cell shares: the chip's peaks, the roofline bound,
the record a cell hands back, and the comparison of a number with its
limit."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W): HBM3
# bandwidth, and float32 on the CUDA cores (the port runs float32 with
# TF32 off).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bound(num_bytes, fp32_flops):
    """(seconds, 'bytes' or 'operations'): the larger of the bytes at the
    card's memory rate and the fp32 operations at its CUDA-core rate
    (chip_smoke.py's ``bound``, in seconds)."""
    ops_s = fp32_flops / FP32_FLOPS
    bytes_s = num_bytes / HBM_BYTES_PER_S
    return (bytes_s, 'bytes') if bytes_s >= ops_s else (ops_s, 'operations')


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Check:
    """One number compared with its limit: the run is correct where every
    value is at most its limit (a NaN is never)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)


def checks_from(values: Dict[str, float], limits: Dict[str, float]
                ) -> List[Check]:
    """The cell's numbers beside the limits of its limits file; a number
    the file does not name is an error of the benchmark."""
    missing = sorted(set(values) - set(limits))
    if missing:
        raise KeyError('no limit for %s' % ', '.join(missing))
    return [Check(name, float(values[name]), float(limits[name]))
            for name in sorted(values)]


@dataclasses.dataclass
class Outcome:
    """What a cell's run hands back to run.py.

    ``end_to_end``: every end-to-end metric the cell can report;
    ``readings``: what the per-layer readers read (spans, counters, the
    device trace, shapes); ``trace``: a traced run's reduced trace
    (harness/trace.py), else None."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    readings: dict
    checks: List[Check]
    memory_peak_bytes: int
    trace: Optional[dict] = None


def rms(a) -> float:
    a = np.asarray(a, np.float64)
    return float(np.sqrt(np.mean(a * a))) if a.size else 0.0


def max_abs(a) -> float:
    """Largest absolute value; NaN if any value is NaN, 0 if empty."""
    a = np.abs(np.asarray(a, np.float64))
    if not a.size:
        return 0.0
    return float('nan') if np.isnan(a).any() else float(a.max())
