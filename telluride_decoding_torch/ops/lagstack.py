"""Temporal lag-window context stacking (port of ops/lagstack.py).

Each frame of a [N, C] signal is concatenated with its ``pre`` preceding
and ``post`` following frames, zero padded at the edges, giving
[N, (pre+1+post)*C]: row n is ``concat(padded[n], ..., padded[n+pre+post])``
where ``padded`` has ``pre`` zero rows in front and ``post`` behind, so
the current frame sits at block index ``pre``.

  * lag_stack_np: host copy (telluride_decoding_tpu/ops/lagstack.py:35-55).
  * lag_stack_reference: plain torch, the semantics of
    telluride_decoding_tpu/ops/lagstack.py:58-67.
  * lag_stack: wrapper of kernel K2 (csrc/lagstack.cu), which replaces
    the Pallas kernel lag_stack_pallas.
  * LagRows: stacked rows held as the raw frames they are stacked from
    (the serving loop's context windows; the port's own, the JAX package
    stacks every served chunk on the host).
"""

from __future__ import annotations

import numpy as np
import torch

from telluride_decoding_torch import kernels


def stacked_width(channels: int, pre: int, post: int) -> int:
    return channels * (pre + 1 + post)


def lag_stack_np(x, pre: int, post: int):
    """Host-side (numpy) lag stacking with identical semantics.

    Uses stride tricks: one zero pad plus a strided [N, total, C] view
    reshaped to [N, total*C].
    """
    x = np.ascontiguousarray(x)
    if x.ndim == 1:
        x = x[:, None]
    if pre == 0 and post == 0:
        return x
    n, c = x.shape
    padded = np.zeros((pre + n + post, c), x.dtype)
    padded[pre:pre + n] = x
    total = pre + 1 + post
    s0, s1 = padded.strides
    view = np.lib.stride_tricks.as_strided(
        padded, shape=(n, total, c), strides=(s0, s0, s1), writeable=False)
    return view.reshape(n, total * c)


class LagRows:
    """n lag-stacked rows of one stream, held as the raw frames
    [pre + n + post, C] they are stacked from: row t is frames[t], ...,
    frames[t + pre + post] laid end to end, the row of frame pre + t.

    An array-like of shape [n, (pre + 1 + post) * C]: ``np.asarray``
    gives the rows, the bits of ``lag_stack_np(frames, pre, post)[pre:pre
    + n]``. A 32-frame push at codelab widths holds 68 x 69 floats where
    its rows take 32 x 2553, so the rows can be stacked where they are
    used (the decoder stacks them on the card with K2).
    """

    __slots__ = ('frames', 'pre', 'post')

    def __init__(self, frames: np.ndarray, pre: int, post: int):
        if frames.ndim != 2 or frames.shape[0] < pre + post:
            raise ValueError('LagRows takes [pre + n + post, C] frames, got '
                             '%s for pre %d, post %d.'
                             % (frames.shape, pre, post))
        self.frames = frames
        self.pre = pre
        self.post = post

    @classmethod
    def empty(cls, channels: int, pre: int, post: int) -> 'LagRows':
        return cls(np.zeros((pre + post, channels), np.float32), pre, post)

    def __len__(self) -> int:
        return self.frames.shape[0] - self.pre - self.post

    @property
    def shape(self) -> tuple:
        return (len(self), stacked_width(self.frames.shape[1], self.pre,
                                         self.post))

    def __array__(self, dtype=None, copy=None):
        del copy  # The rows are always a new array.
        n, width = self.shape
        s0, s1 = self.frames.strides
        view = np.lib.stride_tricks.as_strided(
            self.frames, shape=(n, self.pre + 1 + self.post,
                                self.frames.shape[1]),
            strides=(s0, s0, s1), writeable=False)
        rows = view.reshape(n, width)
        if not rows.flags.writeable:   # A view of the frames, not a copy.
            rows = rows.copy()
        return rows if dtype is None else rows.astype(dtype, copy=False)

    def join(self, later: 'LagRows') -> 'LagRows':
        """These rows followed by ``later``'s, the next rows of the same
        stream (whose first pre + post frames are this window's last)."""
        if not len(later):
            return self
        if not len(self):
            return later
        return LagRows(np.concatenate(
            [self.frames, later.frames[self.pre + self.post:]]),
            self.pre, self.post)

    def split(self, n: int) -> tuple:
        """(the first n rows, the rows after them)."""
        return (LagRows(self.frames[:n + self.pre + self.post], self.pre,
                        self.post),
                LagRows(self.frames[n:], self.pre, self.post))


def lag_stack_reference(x: torch.Tensor, pre: int, post: int
                        ) -> torch.Tensor:
    """Zero-padded lag stacking via shifted slices (plain torch)."""
    if pre == 0 and post == 0:
        return x
    n = x.shape[0]
    padded = torch.nn.functional.pad(x, (0, 0, pre, post))
    return torch.cat([padded[k:k + n] for k in range(pre + 1 + post)],
                     dim=1)


def lag_stack(x: torch.Tensor, pre: int, post: int) -> torch.Tensor:
    """Lag stack of a [N, C] float32 tensor: kernel K2 on CUDA.

    A CPU tensor takes lag_stack_reference. A CUDA tensor launches the
    kernel (one launch per call with pre + post > 0) or raises.
    """
    if pre < 0 or post < 0:
        raise ValueError('pre (%d) and post (%d) must be >= 0.'
                         % (pre, post))
    if x.device.type == 'cpu':
        return lag_stack_reference(x, pre, post)
    if x.device.type != 'cuda':
        raise ValueError('lag_stack takes CPU or CUDA tensors, not %s.'
                         % x.device)
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError('lag_stack kernel takes a contiguous 2-D float32 '
                         'tensor, got %s %s (contiguous=%s).'
                         % (tuple(x.shape), x.dtype, x.is_contiguous()))
    if pre == 0 and post == 0:
        return x
    n, c = x.shape
    out = torch.empty((n, stacked_width(c, pre, post)), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    lib = kernels.library()
    kernels.check(lib.tdt_lag_stack_f32(
        x.data_ptr(), out.data_ptr(), n, c, pre, post,
        kernels.stream_handle(x.device)), 'lag_stack')
    return out
