"""Pearson correlation (port of ops/pearson.py, the parts the CCA model's
metric needs)."""

from __future__ import annotations

import torch


def pearson_correlation(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Column-wise Pearson correlation between two [N, D] tensors.

    Returns a length-D vector. If any column of either side has zero
    power the result is all zeros (telluride_decoding_tpu/ops/pearson.py:45).
    """
    if x.dim() == 1:
        x = x[:, None]
    if y.dim() == 1:
        y = y[:, None]
    if x.shape[-1] != y.shape[-1]:
        raise ValueError('pearson_correlation needs equal widths, got '
                         '%s vs %s.' % (tuple(x.shape), tuple(y.shape)))
    x_m = x - x.mean(0)
    y_m = y - y.mean(0)
    x_p = (x_m * x_m).sum(0)
    y_p = (y_m * y_m).sum(0)
    denom = torch.sqrt(x_p) * torch.sqrt(y_p)
    corr = (x_m * y_m).sum(0) / torch.where(denom <= 0.0,
                                             torch.ones_like(denom), denom)
    zero_cond = torch.logical_or((x_p <= 0).any(), (y_p <= 0).any())
    return torch.where(zero_cond, torch.zeros_like(corr), corr)


def pearson_correlation_first(x: torch.Tensor,
                              y: torch.Tensor) -> torch.Tensor:
    """Correlation of the first output dimension (reference metric)."""
    return pearson_correlation(x, y)[0]
