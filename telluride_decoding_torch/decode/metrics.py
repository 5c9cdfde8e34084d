"""Separation metrics and window averaging for decoder evaluation.

A host-only copy of telluride_decoding_tpu/decode/metrics.py
(calculate_dprime at :16, average_data at :37), kept in numpy so
float64 inputs keep the reference's float64 math.
"""

from __future__ import annotations

import numpy as np


def calculate_dprime(d1, d2):
    """d' sensitivity index between two score distributions.

    (mean2 - mean1) / sqrt((var1 + var2) / 2), population variances,
    exactly as the reference defines it.
    """
    d1 = np.asarray(d1)
    d2 = np.asarray(d2)
    if d1.ndim > 2 or (d1.ndim == 2 and d1.shape[1] > 1):
        raise TypeError("d1 array must be a vector, not size %s."
                        % str(d1.shape))
    if d2.ndim > 2 or (d2.ndim == 2 and d2.shape[1] > 1):
        raise TypeError("d2 array must be a vector, not size %s."
                        % str(d2.shape))
    m1 = np.mean(d1)
    m2 = np.mean(d2)
    v1 = np.var(d1)
    v2 = np.var(d2)
    return float((m2 - m1) / np.sqrt((v1 + v2) / 2.0))


def average_data(data, window_size: int):
    """Averages [N, D] data over non-overlapping windows of window_size.

    Output is [N // window_size, D]; trailing frames that do not fill a
    window are dropped (reference semantics, infer_decoder.py:777-783).
    window_size of 0 or 1 returns the input unchanged.
    """
    data = np.asarray(data)
    if data.ndim != 2:
        raise TypeError("Averaging data must be two dimensional, not %s."
                        % data.ndim)
    if window_size < 0:
        raise ValueError("Window size (%s) must be >= 0." % window_size)
    if window_size <= 1:
        return data
    num_windows = data.shape[0] // window_size
    trimmed = data[:num_windows * window_size, :]
    return trimmed.reshape(num_windows, window_size, -1).mean(axis=1)
