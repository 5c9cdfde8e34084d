"""Windowed audio feature stores for real-time pipelines (copy of
telluride_decoding_tpu/signal/audio_stores.py).

Windowed reductions over a streaming audio buffer (mean-square
intensity; Mick's |x|^log10(2) loudness approximation) built on the
WindowedDataStore.
"""

from __future__ import annotations

import numpy as np

from telluride_decoding_torch.decode.result_store import WindowedDataStore


class AudioIntensityStore(WindowedDataStore):
    """Mean-squared value per window."""

    def next_window(self):
        for win in super().next_window():
            yield np.mean(np.square(win))


class AudioLoudnessMick(WindowedDataStore):
    """Mean of |x|^log10(2) per window (perceptual loudness approx)."""

    def next_window(self):
        for win in super().next_window():
            yield np.mean(np.abs(win) ** np.log10(2))
