"""Pearson correlation primitives (port of ops/pearson.py)."""

from __future__ import annotations

import torch

from telluride_decoding_torch import device as device_policy


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


def pearson_correlation_second(x: torch.Tensor,
                               y: torch.Tensor) -> torch.Tensor:
    """Correlation of the second output dimension (reference metric)."""
    if x.dim() == 1:
        x = x[:, None]
    if x.shape[-1] < 2:
        raise ValueError('pearson_correlation_second needs >= 2 output '
                         'dimensions, got shape %s.' % (tuple(x.shape),))
    return pearson_correlation(x, y)[1]


def pearson_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-frame negative-correlation contributions: summed over the
    batch, minus the total batch correlation (the reference
    PearsonCorrelationLoss, telluride_decoding_tpu/ops/pearson.py:69)."""
    if x.dim() == 1:
        x = x[:, None]
    if y.dim() == 1:
        y = y[:, None]
    if x.shape != y.shape:
        raise ValueError('x and y must have the same shape for the '
                         'Pearson loss, not %s vs %s.' %
                         (tuple(x.shape), tuple(y.shape)))
    x_m = x - x.mean(0)
    y_m = y - y.mean(0)
    power = torch.sqrt((x_m * x_m).sum(0) * (y_m * y_m).sum(0))
    return -((x_m * y_m) / power).sum(-1)


def correlation_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Correlation matrix of the columns of [x | y], (Dx+Dy)^2.

    The product runs in full float32 (TF32 off), as the JAX package runs
    it at Precision.HIGHEST.
    """
    device_policy.full_fp32()
    x = x.float()
    y = y.float()
    if x.dim() == 1:
        x = x[:, None]
    if y.dim() == 1:
        y = y[:, None]
    xy = torch.cat([x, y], dim=1)
    xy_m = xy - xy.mean(0, keepdim=True)
    cov = xy_m.T @ (xy_m / (xy.shape[0] - 1.0))
    inv_std = torch.rsqrt(torch.diagonal(cov))
    return cov * inv_std[:, None] * inv_std[None, :]
