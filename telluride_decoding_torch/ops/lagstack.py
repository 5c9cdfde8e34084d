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
    lag_stack.launches += 1
    return out


lag_stack.launches = 0
