"""Canonical correlation analysis (port of solvers/cca.py).

Covariances come from MomentStats with the reference's normalization;
whitening uses eigh of the symmetrized covariances with tiny eigen-dims
zeroed; the canonical directions come from one SVD. Float32 throughout
with TF32 off, as the JAX package runs it at Precision.HIGHEST.
``cca_loss`` is the deep-CCA objective, differentiable through
``torch.linalg.eigh`` (on CUDA each eigh checks its result on the host,
so a call synchronises with the card three times).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from telluride_decoding_torch.ops.covariance import (MomentStats,
                                                     blocked_moments,
                                                     moments_from_arrays)


class CcaSolution(NamedTuple):
    rot_x: torch.Tensor        # [Dx, dim]
    rot_y: torch.Tensor        # [Dy, dim]
    mean_x: torch.Tensor       # [1, Dx]
    mean_y: torch.Tensor       # [1, Dy]
    eigenvalues: torch.Tensor  # [dim] canonical correlations


def _inv_sqrt_psd(cov: torch.Tensor, eps_eig: float) -> torch.Tensor:
    """cov^{-1/2} for an SPD matrix, zeroing tiny eigen-dims."""
    cov = 0.5 * (cov + cov.T)
    vals, vecs = torch.linalg.eigh(cov)
    inv_sqrt = torch.where(vals > eps_eig,
                           torch.rsqrt(torch.clamp(vals, min=eps_eig)),
                           torch.zeros_like(vals))
    return (vecs * inv_sqrt[None, :]) @ vecs.T


def cca_covariances_from_stats(stats: MomentStats):
    """The reference's CCA covariance normalization.

    The quirk (telluride_decoding_tpu/solvers/cca.py:53-74): sums divide
    by (N - 1) while the subtracted mean outer products use the /N means.
    Returns (mean_x, mean_y, cov_xx, cov_yy, cov_xy), unsymmetrized.
    Leading batch dimensions (one a file, in the sweep) pass through.
    """
    n = stats.count[..., None]
    mean_x = stats.sum_x / n
    mean_y = stats.sum_y / n
    denom = n[..., None] - 1.0

    def outer(a, b):
        return a[..., :, None] * b[..., None, :]
    cov_xx = stats.sxx / denom - outer(mean_x, mean_x)
    cov_yy = stats.syy / denom - outer(mean_y, mean_y)
    cov_xy = stats.sxy / denom - outer(mean_x, mean_y)
    return mean_x, mean_y, cov_xx, cov_yy, cov_xy


def solve_cca_from_moments(stats: MomentStats, dim: int,
                           regularization: float = 0.1,
                           eps_eig: float = 1e-12) -> CcaSolution:
    """CCA rotations from sufficient statistics, regularized by
    ``regularization * I`` on both covariances."""
    (mean_x, mean_y, cov_xx, cov_yy,
     cov_xy) = cca_covariances_from_stats(stats)
    eye_x = torch.eye(cov_xx.shape[0], dtype=cov_xx.dtype,
                      device=cov_xx.device)
    eye_y = torch.eye(cov_yy.shape[0], dtype=cov_yy.dtype,
                      device=cov_yy.device)
    k11 = _inv_sqrt_psd(cov_xx + regularization * eye_x, eps_eig)
    k22 = _inv_sqrt_psd(cov_yy + regularization * eye_y, eps_eig)
    u, e, vt = torch.linalg.svd(k11 @ cov_xy @ k22, full_matrices=False)
    return CcaSolution(rot_x=k11 @ u[:, :dim], rot_y=k22 @ vt.T[:, :dim],
                       mean_x=mean_x[None, :], mean_y=mean_y[None, :],
                       eigenvalues=e[:dim])


def calculate_cca_parameters(x: torch.Tensor, y: torch.Tensor, dim: int,
                             regularization: float = 0.1,
                             eps_eig: float = 1e-12,
                             block: int = 8192) -> CcaSolution:
    """End-to-end CCA fit for in-memory [N, Dx] / [N, Dy] tensors."""
    x = x.float()
    y = y.float()
    if x.shape[0] > block:
        stats = blocked_moments(x, y, block=block, want_syy=True)
    else:
        stats = moments_from_arrays(x, y, want_syy=True)
    return solve_cca_from_moments(stats, dim, regularization, eps_eig)


def apply_cca(solution: CcaSolution, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """Rotates two inputs and concatenates them: [N, 2 dim]."""
    rx = (x - solution.mean_x) @ solution.rot_x
    ry = (y - solution.mean_y) @ solution.rot_y
    return torch.cat([rx, ry], dim=1)


def cca_loss(x: torch.Tensor, y: torch.Tensor, dim: int,
             rcov1: float, rcov2: float,
             eps_eig: float = 1e-12) -> torch.Tensor:
    """Differentiable sum of the top ``dim`` canonical correlations of a
    batch (telluride_decoding_tpu/solvers/cca.py:134-159): centred
    inputs, covariances over N - 1 with ``rcov`` ridges, whitening by
    eigh and the square roots of the top eigenvalues of T T^T. Negate it
    for a loss."""
    x = x - torch.mean(x, dim=0, keepdim=True)
    y = y - torch.mean(y, dim=0, keepdim=True)
    batch_norm = x.shape[0] - 1.0
    eye_x = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    eye_y = torch.eye(y.shape[1], dtype=y.dtype, device=y.device)
    cov_xx = x.T @ x / batch_norm + rcov1 * eye_x
    cov_yy = y.T @ y / batch_norm + rcov2 * eye_y
    cov_xy = x.T @ y / batch_norm
    t = _inv_sqrt_psd(cov_xx, eps_eig) @ cov_xy @ _inv_sqrt_psd(cov_yy,
                                                                eps_eig)
    # Ascending eigenvalues of T T^T: the squared canonical correlations.
    vals = torch.linalg.eigh(t @ t.T)[0]
    return torch.sum(torch.sqrt(torch.clamp(vals[-dim:], min=0.0)))
