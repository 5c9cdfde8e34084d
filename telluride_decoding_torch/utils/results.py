"""results.txt parsing and sweep aggregation (copy of utils/results.py).

The reference's codelab analyzes sweeps by parsing each job's
results.txt — the 'Parameters:' line plus 'Final_Testing/<metric>'
lines (written by decoding.write_experiment_summary; consumed by the
codelab's ad-hoc script, doc/DecodingCodelab.md:432-503). That parser
is part of the ecosystem's load-bearing surface, so it ships as a
utility here: parse one file, or walk a sweep tree and pivot results
by any parameter (e.g. regularization_lambda).
"""

from __future__ import annotations

import collections
import os
from typing import Dict, List, Optional, Tuple


def parse_results_file(path: str) -> Tuple[Dict[str, str],
                                           Dict[str, float]]:
    """Returns (parameters, metrics) from one results.txt."""
    parameters: Dict[str, str] = {}
    metrics: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith('Parameters: '):
                blob = line[len('Parameters: '):]
                for item in blob.split(';'):
                    if '=' in item:
                        k, v = item.split('=', 1)
                        parameters[k.strip()] = v.strip()
            elif line.startswith('Final_Testing/'):
                name, _, value = line[len('Final_Testing/'):].partition(':')
                try:
                    metrics[name.strip()] = float(value)
                except ValueError:
                    # Truncated/odd lines (killed jobs) skip, matching
                    # the parser's lenient design.
                    pass
            elif line.startswith('Final_Test/'):
                name, _, value = line[len('Final_Test/'):].partition(':')
                try:
                    values = [float(x) for x in value.split()]
                except ValueError:
                    continue
                if values:
                    metrics[name.strip()] = (
                        values[0] if len(values) == 1
                        else sum(values) / len(values))
    return parameters, metrics


def collect_sweep_results(base_dir: str, metric: str,
                          parameter: str = 'regularization_lambda'
                          ) -> 'collections.OrderedDict[str, List[float]]':
    """Walks a sweep tree; returns {parameter value: [metric values]}.

    Every results.txt below base_dir contributes one value, keyed by
    the requested parameter from its Parameters line.
    """
    results: 'collections.OrderedDict[str, List[float]]' = (
        collections.OrderedDict())
    for path, _, files in sorted(os.walk(base_dir)):
        if 'results.txt' not in files:
            continue
        params, metrics = parse_results_file(
            os.path.join(path, 'results.txt'))
        if metric not in metrics or parameter not in params:
            continue
        results.setdefault(params[parameter], []).append(metrics[metric])
    return results


def best_parameter(base_dir: str, metric: str,
                   parameter: str = 'regularization_lambda'
                   ) -> Optional[Tuple[str, float]]:
    """The parameter value with the highest mean metric, or None."""
    collected = collect_sweep_results(base_dir, metric, parameter)
    best = None
    for value, metric_values in collected.items():
        mean = sum(metric_values) / len(metric_values)
        if best is None or mean > best[1]:
            best = (value, mean)
    return best
