"""Streaming result buffers for windowed decoding.

A host-only copy of telluride_decoding_tpu/decode/result_store.py
(TwoResultStore at :139 and the stores it is built from): importing the
JAX package's decode subpackage pulls in JAX, which the port must not.
Capability parity with the reference result_store.py (NumpyStore
doubling buffer, WindowedDataStore step/width/pre_context window
extraction, TwoResultStore paired streams).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


class NumpyStore:
    """Growable frame buffer: append minibatches, read back as one array."""

    def __init__(self, init_frame_count: int = 10000,
                 name: str = 'Generic'):
        if init_frame_count <= 0:
            raise ValueError('Initial frame count must be greater than 0, '
                             'not %s' % init_frame_count)
        self._init_frame_count = init_frame_count
        self._name = name
        self._data_store: Optional[np.ndarray] = None
        self._count = 0

    @property
    def count(self) -> int:
        return self._count

    @property
    def all_data(self) -> Optional[np.ndarray]:
        if self._data_store is None:
            return None
        return self._data_store[:self._count, :]

    def _ensure_capacity(self, data: np.ndarray):
        if not isinstance(data, np.ndarray) or data.ndim != 2:
            raise TypeError('data must be a 2D numpy array, not %s' %
                            type(data))
        if self._data_store is None:
            frames = max(self._init_frame_count, 2 * data.shape[0])
            self._data_store = np.zeros((frames, data.shape[1]))
        elif self._data_store.shape[0] < self._count + data.shape[0]:
            new_size = max(self._data_store.shape[0] * 2,
                           self._data_store.shape[0] + 2 * data.shape[0])
            grown = np.zeros((new_size, self._data_store.shape[1]))
            grown[:self._count] = self._data_store[:self._count]
            self._data_store = grown
        if data.shape[1] != self._data_store.shape[1]:
            raise ValueError(
                'Data\'s shape has changed, and this is not allowed '
                '(%d to %d).' % (self._data_store.shape[1], data.shape[1]))

    # Kept for reference-API parity.
    create_storage = _ensure_capacity

    def add_data(self, data: np.ndarray):
        data = np.asarray(data)
        if data.ndim < 2:
            data = np.reshape(data, (-1, 1))
        self._ensure_capacity(data)
        self._data_store[self._count:self._count + data.shape[0]] = data
        self._count += data.shape[0]

    def next_window(self, window_size: int
                    ) -> Iterator[Optional[np.ndarray]]:
        """Pops one window_size chunk from the front (or None if short)."""
        if self._count < window_size:
            yield None
        else:
            chunk = np.copy(self._data_store[:window_size, :])
            keep = self._count - window_size
            self._data_store[:keep] = (
                self._data_store[window_size:self._count])
            self._count = keep
            yield chunk


class WindowedDataStore(NumpyStore):
    """Buffer that yields fixed-width windows advanced by window_step.

    pre_context prepends zero frames once at creation so the first
    window can be centered on sample 0 (reference semantics,
    result_store.py:236-241).
    """

    def __init__(self, window_step: int = 100,
                 window_width: Optional[int] = None,
                 pre_context: int = 0,
                 initial_frame_count: int = 100):
        if int(window_step) != window_step:
            raise ValueError('Must be an integer window_step for now, '
                             'not %g.' % window_step)
        if window_width is None:
            window_width = int(3 * window_step)
        if window_step > window_width:
            raise ValueError('window_step (%d) must be less than or equal '
                             'to window_width (%d)' % (window_step,
                                                       window_width))
        super().__init__(init_frame_count=int(
            initial_frame_count * max(window_step, window_width)))
        self._window_width = int(window_width)
        self._window_step = int(window_step)
        self._pre_context = int(pre_context)
        self._primed = False

    def add_data(self, data: np.ndarray):
        data = np.asarray(data)
        if data.ndim < 2:
            data = np.reshape(data, (-1, 1))
        if not self._primed:
            self._primed = True
            if self._pre_context > 0:
                super().add_data(np.zeros((self._pre_context,
                                           data.shape[1])))
        super().add_data(data)

    @property
    def has_window(self) -> bool:
        """Whether a full window is ready without consuming it."""
        return self._count >= self._window_width

    def next_window(self) -> Iterator[Optional[np.ndarray]]:
        while self._count >= self._window_width:
            chunk = np.copy(self._data_store[:self._window_width, :])
            keep = self._count - self._window_step
            self._data_store[:keep] = (
                self._data_store[self._window_step:self._count])
            self._count = keep
            yield chunk


class TwoResultStore:
    """Two parallel WindowedDataStores yielding paired windows."""

    def __init__(self, window_width: int = 100, window_step: int = 100,
                 pre_context: int = 0, initial_frame_count: int = 100):
        self._store1 = WindowedDataStore(
            window_step, window_width=window_width, pre_context=pre_context,
            initial_frame_count=initial_frame_count)
        self._store2 = WindowedDataStore(
            window_step, window_width=window_width, pre_context=0,
            initial_frame_count=initial_frame_count)

    @property
    def all_data(self) -> Tuple[Optional[np.ndarray],
                                Optional[np.ndarray]]:
        return self._store1.all_data, self._store2.all_data

    def add_data(self, s1: np.ndarray, s2: np.ndarray):
        s1 = np.asarray(s1)
        s2 = np.asarray(s2)
        if s1.shape[0] != s2.shape[0]:
            raise ValueError('Both data must have the same # frames, not '
                             '%d vs. %d' % (s1.shape[0], s2.shape[0]))
        self._store1.add_data(s1)
        self._store2.add_data(s2)

    def next_window(self) -> Iterator[Tuple[Optional[np.ndarray],
                                            Optional[np.ndarray]]]:
        # Pop a window only when BOTH stores have one: with
        # pre_context > 0, store1's zero padding completes its first
        # window before store2's — the reference's nested-loop pairing
        # (result_store.py:327-338) silently DISCARDS store1's early
        # window there and mislabels every subsequent pair by one
        # step. Waiting keeps window i of store1 (centered) paired
        # with window i of store2 (causal) for the whole stream.
        while self._store1.has_window and self._store2.has_window:
            p1 = next(self._store1.next_window())
            p2 = next(self._store2.next_window())
            yield p1, p2
