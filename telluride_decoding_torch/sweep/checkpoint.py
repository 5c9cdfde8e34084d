"""Checkpoint and resume for long parameter sweeps (port of
sweep/checkpoint.py; host only).

A SweepCheckpoint persists each tile of the result matrix as it
completes, so a preempted sweep resumes from the last finished tile.
The on-disk format is the JAX package's: one .npz per tile plus a
manifest.json keyed by a content hash of the sweep configuration
(lambdas, files, model settings), so a checkpoint directory written by
either package resumes in the other. The tile format carries lambda and
file spans; run_sweep_with_checkpoints blocks only the lambda axis.

Unlike the JAX package's copy, saving a tile re-reads the manifest on
disk and merges its tiles (same key) under an exclusive lock before
writing, so two processes sharing a directory do not drop each other's
tile registrations.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def _config_key(lambdas: Sequence[float], file_names: Sequence[str],
                extra: Optional[Dict] = None) -> str:
    blob = json.dumps({'lambdas': [float(l) for l in lambdas],
                       'files': list(file_names),
                       'extra': extra or {}}, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


class SweepCheckpoint:
    """Persists sweep-result tiles; resume skips finished tiles."""

    def __init__(self, checkpoint_dir: str, lambdas: Sequence[float],
                 file_names: Sequence[str],
                 extra_config: Optional[Dict] = None):
        self._dir = checkpoint_dir
        self._key = _config_key(lambdas, file_names, extra_config)
        self._lambdas = list(lambdas)
        self._files = list(file_names)
        os.makedirs(checkpoint_dir, exist_ok=True)
        self._manifest_path = os.path.join(checkpoint_dir,
                                           'manifest.json')
        self._manifest = self._load_manifest()

    def _load_manifest(self) -> Dict:
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                manifest = json.load(f)
            if manifest.get('key') == self._key:
                return manifest
        return {'key': self._key, 'tiles': {}}

    def _save_manifest(self):
        # Under an exclusive lock: re-read the manifest on disk and merge
        # its tiles (this process's registrations win), then publish by
        # a pid-suffixed temp + os.replace so no reader sees a torn file.
        with open(self._manifest_path + '.lock', 'w') as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            on_disk = self._load_manifest()['tiles']
            self._manifest['tiles'] = {**on_disk,
                                       **self._manifest['tiles']}
            tmp = self._manifest_path + '.tmp.%d' % os.getpid()
            with open(tmp, 'w') as f:
                json.dump(self._manifest, f)
            os.replace(tmp, self._manifest_path)

    def _tile_path(self, tile_id: str) -> str:
        return os.path.join(self._dir,
                            'tile_%s_%s.npz' % (self._key, tile_id))

    def has_tile(self, tile_id: str) -> bool:
        return (tile_id in self._manifest['tiles'] and
                os.path.exists(self._tile_path(tile_id)))

    def save_tile(self, tile_id: str, correlations: np.ndarray,
                  lambda_slice: slice, file_slice: slice):
        # Atomic publish: a run killed mid-savez must not leave a torn
        # tile at the final path (ends in .npz so np.savez keeps the
        # name).
        path = self._tile_path(tile_id)
        tmp = path + '.tmp-%d.npz' % os.getpid()
        np.savez(tmp, correlations=correlations,
                 lambda_start=lambda_slice.start or 0,
                 lambda_stop=lambda_slice.stop,
                 file_start=file_slice.start or 0,
                 file_stop=file_slice.stop)
        os.replace(tmp, path)
        self._manifest['tiles'][tile_id] = {
            'lambda': [lambda_slice.start or 0, lambda_slice.stop],
            'file': [file_slice.start or 0, file_slice.stop]}
        self._save_manifest()

    def load_tile(self, tile_id: str) -> np.ndarray:
        with np.load(self._tile_path(tile_id)) as z:
            return z['correlations']

    def assemble(self) -> Optional[np.ndarray]:
        """Full [L, F] matrix if every tile is present, else None."""
        result = np.zeros((len(self._lambdas), len(self._files)))
        # Coverage is an explicit mask, not a NaN sentinel: correlations
        # can be legitimately NaN (shrinkage at lamb = 0 on
        # rank-deficient data has no eig fallback).
        covered = np.zeros(result.shape, bool)
        for tile_id, spans in self._manifest['tiles'].items():
            if not os.path.exists(self._tile_path(tile_id)):
                return None
            tile = self.load_tile(tile_id)
            l0, l1 = spans['lambda']
            f0, f1 = spans['file']
            result[l0:l1, f0:f1] = tile
            covered[l0:l1, f0:f1] = True
        if not covered.all():
            return None
        return result

    @property
    def completed_tiles(self) -> List[str]:
        return [t for t in self._manifest['tiles'] if self.has_tile(t)]


def run_sweep_with_checkpoints(
        sweep_fn: Callable[[Sequence[float], slice], np.ndarray],
        lambdas: Sequence[float], file_names: Sequence[str],
        checkpoint_dir: str, lambda_block: int = 0,
        extra_config: Optional[Dict] = None) -> np.ndarray:
    """Runs a sweep in resumable lambda blocks.

    ``sweep_fn(lambda_block_values, file_slice)`` computes one tile of
    the result ([len(block), num_files]); completed tiles load from the
    checkpoint instead of recomputing. Returns the full [L, F] matrix.
    """
    lambda_block = lambda_block or len(lambdas)
    ckpt = SweepCheckpoint(checkpoint_dir, lambdas, file_names,
                           extra_config)
    num_files = len(file_names)
    result = np.zeros((len(lambdas), num_files))
    for start in range(0, len(lambdas), lambda_block):
        stop = min(start + lambda_block, len(lambdas))
        tile_id = 'l%d-%d' % (start, stop)
        if ckpt.has_tile(tile_id):
            tile = ckpt.load_tile(tile_id)
        else:
            tile = np.asarray(sweep_fn(list(lambdas[start:stop]),
                                       slice(0, num_files)))
            ckpt.save_tile(tile_id, tile, slice(start, stop),
                           slice(0, num_files))
        result[start:stop, :] = tile
    return result
