"""Streaming signal preprocessing: filter, resample, re-ref, context
(port of signal/preprocess.py).

The same fixed 7-step ``process()`` order (highpass -> lowpass ->
resample -> re-reference -> channel select -> normalize -> add
context), the same batch-streaming state (filter state, context edges,
resampler phase), the same ``name(k=v;k=v)`` constructor and the same
anti-alias auto-lowpass at 0.75x the output Nyquist. Inputs and outputs
are numpy arrays, as in the JAX API; each object takes a ``device``
(default ``cuda``) on which its filters and its audio envelope run.

Audio intensity (``AudioFeatures.compute_intensity``) routes as the JAX
package does (preprocess.py:437-498): on a CUDA device the
non-streaming single-stream downsampling case runs kernel K3
(ops/fused_frontend.py); a streaming continuation, a multi-channel
input, the pass-through case and every CPU call take the float64
cumsum path. On the card K3 runs or the call raises: there is no
switch and no fallback.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

from telluride_decoding_torch import device as device_policy
from telluride_decoding_torch.ops.fused_frontend import (
    fused_envelope_lagstack)
from telluride_decoding_torch.ops.lagstack import lag_stack_np
from telluride_decoding_torch.signal import filters


class Preprocessor:
    """Stateful per-recording preprocessor; call process() per batch."""

    def __init__(self, name: str, fs_in: float, fs_out: float,
                 highpass_cutoff: float = 0, highpass_order: int = 4,
                 lowpass_cutoff: float = 0, lowpass_order: int = 4,
                 ref_channels=None, channels_to_ref=None,
                 channel_numbers=None,
                 data_mean: Optional[float] = 0,
                 data_std: Optional[float] = 1,
                 pre_context: int = 0, post_context: int = 0,
                 device='cuda'):
        if not isinstance(name, str):
            raise TypeError('name must be a string, not %s' % name)
        if fs_in <= 0 or fs_out <= 0:
            raise ValueError('sample rates must be positive.')
        if highpass_cutoff < 0 or lowpass_cutoff < 0:
            raise ValueError('filter cutoffs must be >= 0.')
        if highpass_cutoff and highpass_order <= 0:
            raise ValueError('highpass_order must be positive.')
        if lowpass_cutoff and lowpass_order <= 0:
            raise ValueError('lowpass_order must be positive.')
        if data_std is not None and data_std <= 0:
            raise ValueError('data_std must be greater than 0.')
        if pre_context < 0 or post_context < 0:
            raise ValueError('context must be >= 0.')
        self.device = device_policy.resolve(device)
        self._fs_in = fs_in
        self._fs_out = fs_out
        self._name = name
        if '(' in name:
            self._init_from_string(name)
        else:
            self.init_highpass(highpass_cutoff, highpass_order)
            self.init_channel_numbers(channel_numbers)
        self.init_lowpass(lowpass_cutoff, lowpass_order)
        self._ref_channels = ref_channels
        self._channels_to_ref = channels_to_ref
        self._data_mean = data_mean
        self._data_std = data_std
        self._pre_context = int(pre_context)
        self._post_context = int(post_context)
        self.context_reset()
        self._highpass_state = None
        self._lowpass_state = None
        self._next_frame_idx = 0

    # -- configuration -------------------------------------------------------

    def init_highpass(self, highpass_cutoff, highpass_order):
        self._highpass_cutoff = highpass_cutoff
        self._highpass_order = highpass_order
        if highpass_cutoff > 0:
            self._highpass_sos = filters.butter_sos(
                highpass_order, highpass_cutoff, 'hp', fs=self._fs_in)
        else:
            self._highpass_sos = None
        self._highpass_state = None

    def init_lowpass(self, lowpass_cutoff, lowpass_order):
        self._lowpass_cutoff = lowpass_cutoff
        self._lowpass_order = lowpass_order
        if lowpass_cutoff > 0 or self._fs_out < self._fs_in:
            nyquist = self._fs_out / 2
            if lowpass_cutoff > nyquist or (self._fs_out < self._fs_in and
                                            lowpass_cutoff == 0):
                # Anti-alias guard (reference preprocess.py:134-141).
                lowpass_cutoff = 0.75 * nyquist
                lowpass_order = 10
                self._lowpass_cutoff = lowpass_cutoff
                self._lowpass_order = lowpass_order
            self._lowpass_sos = filters.butter_sos(
                lowpass_order, lowpass_cutoff, 'lp', fs=self._fs_in)
        else:
            self._lowpass_sos = None
        self._lowpass_state = None

    def init_channel_numbers(self, channel_numbers):
        """Parses '0-3,7'-style channel selections."""
        if isinstance(channel_numbers, int):
            self._channel_numbers = [channel_numbers]
        elif isinstance(channel_numbers, list):
            self._channel_numbers = channel_numbers
        elif isinstance(channel_numbers, str):
            pieces = (channel_numbers.split(',') if ',' in channel_numbers
                      else [channel_numbers])

            def expand(piece):
                if '-' in piece:
                    lo, hi = piece.split('-')
                    return list(range(int(lo), int(hi) + 1))
                return [int(piece)]

            expanded = np.concatenate([expand(p) for p in pieces])
            self._channel_numbers = np.unique(expanded).tolist()
        else:
            self._channel_numbers = None

    def _init_from_string(self, param_string: str):
        """Parses 'name(key=val;key=val)' constructors
        (reference preprocess.py:550-586)."""
        pieces = re.match(r'(\w*)\((.*)\)$', param_string)
        if not pieces:
            raise ValueError('Bad preprocessor param string: %s' %
                             param_string)
        self._name = pieces.group(1)
        param_dict = {}
        for param in pieces.group(2).split(';'):
            if '=' not in param:
                raise ValueError('preprocess param %s missing a value.' %
                                 param)
            k, v = param.split('=', 1)
            if v.isdigit():
                v = int(v)
            else:
                try:
                    v = float(v)
                except ValueError:
                    pass
            param_dict[k] = v
        known = {'highpass_cutoff', 'highpass_order', 'channel_numbers'}
        unknown = set(param_dict) - known
        if unknown:
            raise ValueError('Unknown preprocess param(s) %s in %s '
                             '(known: %s).' %
                             (sorted(unknown), param_string,
                              sorted(known)))
        cutoff = param_dict.get('highpass_cutoff', 0)
        order = param_dict.get('highpass_order', 4)
        if not isinstance(cutoff, (int, float)) or cutoff < 0:
            raise ValueError('highpass_cutoff must be >= 0, got %r in '
                             '%s' % (cutoff, param_string))
        if cutoff and (not isinstance(order, int) or order <= 0):
            raise ValueError('highpass_order must be a positive '
                             'integer, got %r in %s'
                             % (order, param_string))
        self.init_highpass(cutoff, order)
        self.init_channel_numbers(param_dict.get('channel_numbers'))

    # -- properties -----------------------------------------------------------

    @property
    def name(self):
        return self._name

    @property
    def fs_in(self):
        return self._fs_in

    @property
    def fs_out(self):
        return self._fs_out

    @property
    def highpass_cutoff(self):
        return self._highpass_cutoff

    @property
    def highpass_order(self):
        return self._highpass_order

    @property
    def lowpass_cutoff(self):
        return self._lowpass_cutoff

    @property
    def lowpass_order(self):
        return self._lowpass_order

    @property
    def channel_numbers(self):
        return self._channel_numbers

    # -- processing steps -----------------------------------------------------

    @staticmethod
    def check_dims(data):
        if np.ndim(data) != 2:
            raise ValueError('Input data must be a two dimensional numpy '
                             'array.')

    def _filter(self, sos, state, data, reset):
        """(filtered numpy data, new device state) of one IIR stage."""
        data = np.asarray(data)
        x = device_policy.as_tensor(data.astype(np.float32), self.device)
        if state is None or reset:
            state = filters.streaming_state_init(
                sos, torch.as_tensor(data[0].astype(np.float64),
                                     device=self.device))
        out, state = filters.sosfilt(sos, x, state)
        return out.cpu().numpy(), state

    def highpass_filter(self, data, reset: bool = False):
        data = np.asarray(data)
        if self._highpass_sos is None:
            return data
        out, self._highpass_state = self._filter(
            self._highpass_sos, self._highpass_state, data, reset)
        return out

    def lowpass_filter(self, data, reset: bool = False):
        data = np.asarray(data)
        if self._lowpass_sos is None:
            return data
        out, self._lowpass_state = self._filter(
            self._lowpass_sos, self._lowpass_state, data, reset)
        return out

    def resample(self, data):
        """Nearest-neighbor resampling as one vectorized gather."""
        if self._fs_out == self._fs_in:
            return data
        if self._next_frame_idx != 0:
            raise ValueError('New sample rate incompatable with batch '
                             'size.')
        frames_in = data.shape[0]
        len_data = float(frames_in) / self._fs_in
        frames_out = int(np.round(len_data * self._fs_out))
        delta_out = 1.0 / self._fs_out
        self._next_frame_idx = int(
            np.round(frames_out * delta_out * self._fs_in)) - frames_in
        idx = np.minimum(
            frames_in - 1,
            np.round(np.arange(frames_out) * delta_out *
                     self._fs_in)).astype(np.int64)
        return data[idx, :]

    def reref_data(self, data):
        if self._ref_channels is None and self._channels_to_ref is None:
            return data
        ref_channels = self._ref_channels
        channels_to_ref = self._channels_to_ref
        if ref_channels is None:
            ref_channels = [range(data.shape[1])]
        if channels_to_ref is None:
            channels_to_ref = [range(data.shape[1])]
        original = np.copy(data)
        # Subtract on a copy, promoting integer EEG to float.
        data = np.array(
            data, dtype=np.promote_types(np.asarray(data).dtype,
                                         np.float32), copy=True)
        for ref, chans in zip(ref_channels, channels_to_ref):
            data[:, list(chans)] -= np.mean(original[:, list(ref)], axis=1,
                                            keepdims=True)
        return data

    def select_channels(self, data):
        if self._channel_numbers:
            return data[:, self._channel_numbers]
        return data

    def find_mean_std(self, data):
        if self._data_mean is None:
            self._data_mean = np.mean(data)
        if self._data_std is None:
            self._data_std = np.std(data)

    def normalize_data(self, data):
        self.find_mean_std(data)
        return (data - self._data_mean) / self._data_std

    def add_context(self, data):
        """Lag stacking with carried edge state across batches
        (reference preprocess.py:468-522): each output frame sees
        pre+post neighbors; the last pre+post input frames roll into
        the next batch."""
        pre, post = self._pre_context, self._post_context
        if pre == 0 and post == 0:
            return data
        num_features = data.shape[1]
        if self._context_state is None:
            self._context_state = np.zeros((pre, num_features), data.dtype)
        data = np.concatenate((self._context_state, data))
        self._context_state = data[-(pre + post):, :]
        stacked = lag_stack_np(data, pre, post)
        return stacked[pre:data.shape[0] - post]

    def context_reset(self):
        self._context_state = None

    def process(self, data, reset: bool = False):
        """All 7 steps in the reference's fixed order."""
        data = np.asarray(data)
        self.check_dims(data)
        data = self.highpass_filter(data, reset=reset)
        data = self.lowpass_filter(data, reset=reset)
        data = self.resample(data)
        data = self.reref_data(data)
        data = self.select_channels(data)
        data = self.normalize_data(data)
        data = self.add_context(data)
        return data


class AudioFeatures:
    """Audio feature extraction: RMS intensity, resample, spectrogram
    (reference preprocess.py:589-755)."""

    def __init__(self, name: str, fs_in: float, fs_out: float,
                 window: float = 1, exponent: float = 1, buff=None,
                 device='cuda'):
        if not isinstance(name, str):
            raise TypeError('name must be a string, not %s' % name)
        if fs_in <= 0 or fs_out <= 0:
            raise ValueError('sample rates must be positive.')
        if window <= 0:
            raise ValueError('window must be greater than than 0.')
        self.device = device_policy.resolve(device)
        self._name = name
        self._fs_in = fs_in
        self._fs_out = fs_out
        self._window = window
        self._exponent = exponent
        self._buff = buff

    def _keep(self) -> int:
        """Streaming tail length: half an averaging window of samples."""
        return int(self._fs_in * 0.5 * self._window / self._fs_out)

    def audio_resample(self, data):
        """Overlapping moving-average resample, vectorized via a float64
        cumulative sum."""
        data = np.asarray(data)
        if data.ndim <= 1:
            data = np.reshape(data, (-1, 1))
        if data.shape[1] > data.shape[0]:
            data = np.transpose(data)

        if not (self._fs_out < self._fs_in or self._window > 1):
            # Pass-through regime (fs_out >= fs_in, window <= 1): no
            # buffering, so a stream never re-emits earlier frames.
            return data

        half_window = 0.5 * self._window / self._fs_out
        if self._buff is not None:
            data = np.concatenate((self._buff, data), axis=0)
            tau = self._buff.shape[0]
        else:
            tau = 0
        keep = self._keep()
        # keep == 0 must keep nothing: data[-0:] is the whole array.
        self._buff = data[-keep:, :] if keep > 0 else data[:0, :]

        frames_in = data.shape[0]
        frames_out = int(round((frames_in - tau) / self._fs_in *
                               self._fs_out))

        t = np.arange(frames_out, dtype=np.float64) / self._fs_out
        t1 = np.maximum(0, np.round(self._fs_in *
                                    (t - half_window)) + tau).astype(int)
        t2 = np.minimum(frames_in, np.round(
            self._fs_in * (t + half_window)) + tau).astype(int)
        # float64 accumulation: a float32 prefix sum cancels most of the
        # mantissa at the tail of a long recording.
        csum = np.concatenate([np.zeros((1, data.shape[1])),
                               np.cumsum(data, axis=0,
                                         dtype=np.float64)])
        counts = np.maximum(t2 - t1, 1)[:, None]
        return (csum[t2] - csum[t1]) / counts

    def compute_intensity(self, data):
        """Windowed RMS with optional amplitude compression.

        On a CUDA device the non-streaming single-stream downsampling
        case runs kernel K3; every other case, and every CPU call,
        takes the cumsum path, as in the JAX package.
        """
        data = np.asarray(data, dtype=np.float32)
        if self.device.type == 'cuda':
            fused = self._fused_intensity(data)
            if fused is not None:
                return fused
        data = self.audio_resample(data ** 2) ** 0.5
        return data ** self._exponent

    def _fused_intensity(self, data):
        """[M, 1] float32 envelope by K3, or None where the JAX package
        takes its cumsum path: a streaming continuation, the
        pass-through case, a multi-channel or too short input."""
        if self._buff is not None:
            return None
        if not (self._fs_out < self._fs_in or self._window > 1):
            return None
        flat = np.squeeze(data)
        if flat.ndim != 1 or flat.shape[0] < 2:
            return None
        audio = torch.from_numpy(np.ascontiguousarray(flat)).to(self.device)
        env = fused_envelope_lagstack(
            audio, float(self._fs_in), float(self._fs_out),
            window=float(self._window), exponent=float(self._exponent))
        # The streaming state as audio_resample leaves it: the tail of
        # the squared signal, half a window long, empty when that rounds
        # to zero samples.
        keep = self._keep()
        tail = flat[-keep:] if keep > 0 else flat[:0]
        self._buff = (tail ** 2).reshape(-1, 1)
        return env.cpu().numpy()

    def compute_spectrogram(self, wave, segment_size: int = 128,
                            n_overlap: int = 8, n_trans: int = 4,
                            smoothing_filter=(.2, 1, .2)):
        """Auditory-style spectrogram: preemphasis + STFT + smoothing +
        fourth-root compression (reference preprocess.py:713-755)."""
        import scipy.signal
        wave = np.squeeze(wave).astype(np.float32)
        if len(wave.shape) != 1:
            raise ValueError('Wave.shape wrong:' + str(wave.shape))
        premph = scipy.signal.lfilter([1, -0.95], [1], wave)
        f, _, spectrum = scipy.signal.stft(
            premph, fs=1.0, window='hamming', nperseg=segment_size,
            noverlap=segment_size - (segment_size / n_overlap),
            nfft=segment_size * n_trans, return_onesided=True)
        spectrum = np.real(spectrum * np.conj(spectrum))
        spectrum = scipy.signal.lfilter(smoothing_filter, [1], spectrum,
                                        axis=0)
        spectrum = scipy.signal.lfilter(smoothing_filter, [1], spectrum,
                                        axis=1)
        off = 0.0001 * np.max(spectrum)
        spectrum = (off + spectrum) ** 0.25 - off ** 0.25
        spectrum = 255 / np.max(spectrum) * spectrum
        return spectrum, f
