"""Multi-process cohort sweeps: partition and exact join through part
files (port of parallel/multihost.py, its host half).

The reference scales a cohort past one machine by launching independent
OS processes and joining their result files afterwards. Subjects share
nothing in a cohort jackknife, so the only communication the sweep needs
is the final summary reduction. Every partition writes one atomic part
file (JSON) holding its per-lambda sufficient statistics (count, sum and
sum of squares over held-out-trial correlations); the joining partition
waits for all parts and reduces them in float64, so a partitioned cohort
reproduces the single-process summary up to the order of float64 sums.

Plain numpy and JSON, with the JAX package's part-file name and keys: a
part written by either package joins in the other. The JAX package's
collective join (``initialize``, ``allgather_summary``) needs a process
group and is not ported yet.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PART_PREFIX = 'cohort_part_'


def partition_subjects(subjects, index: int, count: int):
    """Deterministic round-robin shard of a subject collection.

    ``subjects`` is a dict (name -> anything) or a sequence of names;
    the shard is chosen by SORTED name so every partition computes the
    same assignment independently (no coordination needed). Returns
    the same container type (dict subset or list).
    """
    if count <= 0:
        raise ValueError('count must be positive, got %d' % count)
    if not 0 <= index < count:
        raise ValueError('index %d outside [0, %d)' % (index, count))
    names = sorted(subjects)
    mine = [n for i, n in enumerate(names) if i % count == index]
    if hasattr(subjects, 'items'):
        return {n: subjects[n] for n in mine}
    return mine


def summary_stats(results) -> np.ndarray:
    """[3, L] float64 sufficient statistics (n, sum, sumsq) per lambda
    over every held-out-trial column of every subject's SweepResult —
    the partitioned form of sweep.engine.cohort_summary."""
    blocks = [np.asarray(r.correlations, np.float64)
              for r in results.values()]
    if not blocks:
        raise ValueError('summary_stats needs at least one subject; '
                         'write an explicit empty part for an empty '
                         'shard via write_part(results={}).')
    all_corr = np.concatenate(blocks, axis=1)
    return np.stack([
        np.full((all_corr.shape[0],), float(all_corr.shape[1])),
        np.sum(all_corr, axis=1),
        np.sum(all_corr ** 2, axis=1),
    ])


def reduce_stats(stats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, std) per lambda from summed [3, L] statistics (population
    std, matching np.std / cohort_summary)."""
    n = np.maximum(stats[0], 1.0)
    mean = stats[1] / n
    var = np.maximum(stats[2] / n - mean ** 2, 0.0)
    return mean, np.sqrt(var)


def part_path(part_dir: str, index: int) -> str:
    return os.path.join(part_dir, '%s%05d.json' % (_PART_PREFIX, index))


def write_part(part_dir: str, index: int, lambdas: Sequence[float],
               results) -> str:
    """Atomically writes one partition's part file.

    ``results`` may be empty (a shard with more partitions than
    subjects) — the part then contributes exact-zero statistics, so
    over-partitioned cohorts still join.
    """
    os.makedirs(part_dir, exist_ok=True)
    lambdas = [float(l) for l in lambdas]
    if results:
        stats = summary_stats(results)
        if stats.shape[1] != len(lambdas):
            raise ValueError(
                'results have %d lambda rows but %d lambdas given'
                % (stats.shape[1], len(lambdas)))
    else:
        stats = np.zeros((3, len(lambdas)))
    payload = {
        'partition_index': index,
        'lambdas': lambdas,
        'subjects': sorted(results),
        'n': stats[0].tolist(),
        'sum': stats[1].tolist(),
        'sumsq': stats[2].tolist(),
    }
    path = part_path(part_dir, index)
    tmp = path + '.tmp.%d' % os.getpid()
    with open(tmp, 'w') as f:
        json.dump(payload, f)
    os.replace(tmp, path)   # Atomic: the joiner never sees a torn part.
    return path


def join_parts(part_dir: str, count: int,
               lambdas: Optional[Sequence[float]] = None,
               timeout_s: float = 1200.0, poll_s: float = 0.5,
               expected_shards: Optional[dict] = None,
               ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Waits for all ``count`` part files and reduces them exactly.

    Returns (mean, std, subjects) where subjects is the union of every
    partition's subject list (for sanity reporting). Raises TimeoutError
    naming the missing partitions, and ValueError on a lambda-grid
    mismatch between parts (two partitions swept different grids —
    joining them would average incomparable rows).

    ``expected_shards`` ({index: sorted subject names}) guards against
    STALE parts in a reused directory: a leftover part file from an
    earlier run over a different cohort or partitioning fails loudly
    instead of silently joining into the summary. (A stale part from
    an identical cohort/grid run is indistinguishable by content —
    call clean_parts before reusing a directory when the underlying
    data may have changed.)
    """
    deadline = time.monotonic() + timeout_s
    want = {part_path(part_dir, i) for i in range(count)}
    while True:
        missing = [p for p in sorted(want) if not os.path.exists(p)]
        if not missing:
            break
        if time.monotonic() >= deadline:
            raise TimeoutError(
                'join_parts: %d/%d parts missing after %.0fs: %s'
                % (len(missing), count, timeout_s,
                   ', '.join(os.path.basename(m) for m in missing)))
        time.sleep(poll_s)
    total = None
    ref_lambdas = [float(l) for l in lambdas] if lambdas is not None \
        else None
    subjects: List[str] = []
    for i in range(count):
        with open(part_path(part_dir, i)) as f:
            payload = json.load(f)
        if ref_lambdas is None:
            ref_lambdas = [float(l) for l in payload['lambdas']]
        elif [float(l) for l in payload['lambdas']] != ref_lambdas:
            raise ValueError(
                'part %d swept lambdas %s, expected %s'
                % (i, payload['lambdas'], ref_lambdas))
        if (expected_shards is not None
                and sorted(payload['subjects'])
                != sorted(expected_shards.get(i, []))):
            raise ValueError(
                'part %d covers subjects %s but this run assigned %s '
                'to it — stale part file from an earlier run? '
                '(clean_parts(%r) removes leftovers)'
                % (i, payload['subjects'],
                   sorted(expected_shards.get(i, [])), part_dir))
        stats = np.stack([np.asarray(payload[k], np.float64)
                          for k in ('n', 'sum', 'sumsq')])
        total = stats if total is None else total + stats
        subjects.extend(payload['subjects'])
    mean, std = reduce_stats(total)
    return mean, std, sorted(subjects)


def clean_parts(part_dir: str) -> None:
    """Removes stale part files (call before re-running a sweep into a
    reused directory — a leftover part from an earlier grid would
    otherwise join into the new summary)."""
    for p in glob.glob(os.path.join(part_dir, _PART_PREFIX + '*.json')):
        os.remove(p)
