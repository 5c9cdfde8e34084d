"""Per-file moments of raw streams (port of the device part of
data/brain_data.py)."""

from __future__ import annotations

import torch

from telluride_decoding_torch.ops.covariance import (MomentStats,
                                                     blocked_moments)
from telluride_decoding_torch.ops.lagstack import lag_stack


def device_file_moments(x_raw: torch.Tensor, y_raw: torch.Tensor,
                        n_true: int, *, pre: int, post: int, pre_y: int,
                        post_y: int, want_syy: bool) -> MomentStats:
    """One file's MomentStats: lag stack (kernel K2) + masked moments.

    Counterpart of _device_file_moments
    (telluride_decoding_tpu/data/brain_data.py:73-103). Rows >= n_true
    are masked out of the sums; rows past the stream end are zeros, the
    lag stack's own edge semantics, so a row near the end sees real
    post-context frames where the buffer holds them.
    """
    x = lag_stack(x_raw, pre, post)
    y = lag_stack(y_raw, pre_y, post_y)
    valid = (torch.arange(x.shape[0], device=x.device) < n_true).float()
    return blocked_moments(x, y, want_syy=want_syy, valid=valid)
