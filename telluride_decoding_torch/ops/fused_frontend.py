"""Audio envelope + lag stack (port of ops/fused_frontend.py).

[N] audio at fs_in becomes [M, pre+1+post] features at fs_out,
M = round(N * fs_out / fs_in):

  e[m] = (mean_{t1(m) <= j < t2(m)} x[j]^2)^(1/2) ^ exponent
  row m = [e[m-pre], ..., e[m], ..., e[m+post]]   (zero-padded edges)

with t1(m) = max(0, round(fs_in * (m/fs_out - window/(2 fs_out)))) and
t2(m) = min(N, round(fs_in * (m/fs_out + window/(2 fs_out)))), in float64
with numpy's round-half-to-even (fused_frontend.py:46-57,
preprocess.py:421-425).

Bucketed inputs: ``valid_len`` (the true sample count of an audio
zero-padded past it) clamps t2 there, and frames m >= ``valid_out`` have
a zero envelope; rows just past valid_out still carry lag-shifted valid
frames in their pre columns.

  * window_bounds: the host float64 bounds, shared by both versions (the
    kernel's wrapper keeps them on the device per geometry).
  * fused_envelope_lagstack_reference: plain torch, the masked gather of
    fused_frontend.py:39-78 (never a prefix sum).
  * fused_envelope_lagstack: wrapper of kernel K3
    (csrc/fused_frontend.cu), which replaces the Pallas kernel of the
    same name. The TPU tiling arguments (out_tile, interpret) are gone.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from telluride_decoding_torch import kernels


def num_frames_out(num_in: int, fs_in: float, fs_out: float) -> int:
    return int(round(num_in / fs_in * fs_out))


def window_bounds(num_in: int, fs_in: float, fs_out: float, window: float,
                  valid_len: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """int32 [M] window starts t1 and ends t2 of each output frame."""
    num_out = num_frames_out(num_in, fs_in, fs_out)
    half = 0.5 * window / fs_out
    m = np.arange(num_out, dtype=np.float64)
    end = num_in if valid_len is None else min(num_in, valid_len)
    t1 = np.maximum(0, np.round(fs_in * (m / fs_out - half)))
    t2 = np.minimum(end, np.round(fs_in * (m / fs_out + half)))
    return t1.astype(np.int32), t2.astype(np.int32)


@functools.lru_cache(maxsize=16)
def _device_bounds(num_in: int, fs_in: float, fs_out: float, window: float,
                   valid_len: Optional[int], device: torch.device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """window_bounds uploaded to ``device``, kept per geometry: tracks of
    one length reuse them instead of recomputing and copying them (a
    synchronous host-to-device copy) on every call."""
    return tuple(torch.as_tensor(b).to(device) for b in window_bounds(
        num_in, fs_in, fs_out, window, valid_len))


def _check_args(audio: torch.Tensor, fs_in, fs_out, window, pre, post,
                valid_len, valid_out) -> Tuple[int, int]:
    """(num_out, valid_out) after validating the arguments."""
    if fs_in <= 0 or fs_out <= 0 or window <= 0:
        raise ValueError('fs_in, fs_out and window must be positive.')
    if pre < 0 or post < 0:
        raise ValueError('pre (%d) and post (%d) must be >= 0.'
                         % (pre, post))
    num_in = audio.numel()
    num_out = num_frames_out(num_in, fs_in, fs_out)
    if valid_len is not None and not 0 <= valid_len <= num_in:
        raise ValueError('valid_len %d is outside [0, %d].'
                         % (valid_len, num_in))
    if valid_out is None:
        valid_out = num_out
    if not 0 <= valid_out <= num_out:
        raise ValueError('valid_out %d is outside [0, %d].'
                         % (valid_out, num_out))
    return num_out, valid_out


def fused_envelope_lagstack_reference(
        audio: torch.Tensor, fs_in: float, fs_out: float,
        window: float = 2.0, exponent: float = 1.0, pre: int = 0,
        post: int = 0, valid_len: Optional[int] = None,
        valid_out: Optional[int] = None) -> torch.Tensor:
    """Plain torch semantics: [N] audio -> [M, pre+1+post] float32.

    Per-window sums by a masked gather of [M, longest window] squared
    samples, as the spec of the JAX package does; a float32 prefix sum
    would cancel most of the mantissa at the tail of a long recording.
    """
    audio = audio.reshape(-1).float()
    num_out, valid_out = _check_args(audio, fs_in, fs_out, window, pre,
                                     post, valid_len, valid_out)
    t1_np, t2_np = window_bounds(audio.numel(), fs_in, fs_out, window,
                                 valid_len)
    t1 = torch.as_tensor(t1_np, device=audio.device).long()
    t2 = torch.as_tensor(t2_np, device=audio.device).long()
    w_max = max(1, int(np.max(t2_np - t1_np)) if num_out else 1)
    idx = t1[:, None] + torch.arange(w_max, device=audio.device)[None, :]
    valid = idx < t2[:, None]
    squared = audio ** 2
    seg = torch.where(
        valid, squared[idx.clamp(0, max(audio.numel() - 1, 0))],
        torch.zeros((), device=audio.device))
    counts = torch.clamp(t2 - t1, min=1).float()
    env = (seg.sum(dim=1) / counts) ** 0.5
    env = env ** exponent
    env = torch.where(torch.arange(num_out, device=audio.device) < valid_out,
                      env, torch.zeros((), device=audio.device))
    padded = torch.nn.functional.pad(env, (pre, post))
    return torch.stack([padded[k:k + num_out]
                        for k in range(pre + 1 + post)], dim=1)


def fused_envelope_lagstack(
        audio: torch.Tensor, fs_in: float, fs_out: float,
        window: float = 2.0, exponent: float = 1.0, pre: int = 0,
        post: int = 0, valid_len: Optional[int] = None,
        valid_out: Optional[int] = None) -> torch.Tensor:
    """Envelope + lag stack of a float32 audio tensor: kernel K3 on CUDA.

    A CPU tensor takes fused_envelope_lagstack_reference. A CUDA tensor
    launches the kernel (one launch per call with M > 0) or raises.
    """
    if audio.device.type == 'cpu':
        return fused_envelope_lagstack_reference(
            audio, fs_in, fs_out, window, exponent, pre, post, valid_len,
            valid_out)
    if audio.device.type != 'cuda':
        raise ValueError('fused_envelope_lagstack takes CPU or CUDA tensors, '
                         'not %s.' % audio.device)
    if audio.dtype != torch.float32 or not audio.is_contiguous():
        raise ValueError('fused_envelope_lagstack kernel takes a contiguous '
                         'float32 tensor, got %s (contiguous=%s).'
                         % (audio.dtype, audio.is_contiguous()))
    audio = audio.reshape(-1)
    if audio.numel() >= 2 ** 31:
        raise ValueError('audio of %d samples exceeds the kernel\'s int32 '
                         'indices.' % audio.numel())
    num_out, valid_out = _check_args(audio, fs_in, fs_out, window, pre,
                                     post, valid_len, valid_out)
    out = torch.empty((num_out, pre + 1 + post), dtype=torch.float32,
                      device=audio.device)
    if num_out == 0:
        return out
    t1, t2 = _device_bounds(audio.numel(), float(fs_in), float(fs_out),
                            float(window), valid_len, audio.device)
    lib = kernels.library()
    kernels.check(lib.tdt_fused_envelope_lagstack(
        audio.data_ptr(), t1.data_ptr(), t2.data_ptr(), out.data_ptr(),
        num_out, valid_out, pre, post, float(exponent),
        kernels.stream_handle(audio.device)), 'fused_envelope_lagstack')
    return out
