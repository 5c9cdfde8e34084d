"""Ridge and shrinkage linear regression from moments (port of
solvers/ridge.py).

The regularized normal equations are built from MomentStats and solved
with ``torch.linalg.solve``; the JAX package solves them outside any
Pallas kernel too. Regularization modes, as there:

  * ridge (use_ridge=True): cov += lamb * I (the reference default).
  * shrinkage (use_ridge=False): Blankertz et al. 2011 eq. 12, shrinking
    eigenvalues toward their mean; lamb == -1 selects the Ledoit-Wolf
    automatic shrinkage.

The bias column of the reference (a column of ones appended to x) is
rebuilt algebraically from the moments, so the solved system is the
reference's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from telluride_decoding_torch.ops.covariance import (MomentStats,
                                                     blocked_moments,
                                                     moments_from_arrays)


class RidgeSolution(NamedTuple):
    w: torch.Tensor          # [Dx, Dy] weights
    b: torch.Tensor          # [Dy] bias
    cov_x: torch.Tensor      # regularized input covariance (augmented)
    cov_xy: torch.Tensor     # input/output cross covariance (augmented)
    shrinkage: torch.Tensor  # effective shrinkage/regularization used


def _augmented_moments(stats: MomentStats):
    """The reference's augmented (x|1) moment matrices.

    With z = [x, 1]: sum z^T z = [[sxx, sum_x^T], [sum_x, n]] and
    sum z^T y = [[sxy], [sum_y]]. Leading batch dimensions (one a file,
    in the sweep) pass through.
    """
    n = stats.count
    sx = stats.sum_x[..., :, None]
    top = torch.cat([stats.sxx, sx], dim=-1)
    bot = torch.cat([sx.transpose(-1, -2), n[..., None, None]], dim=-1)
    szz = torch.cat([top, bot], dim=-2)
    szy = torch.cat([stats.sxy, stats.sum_y[..., None, :]], dim=-2)
    return szz, szy


def solve_ridge_from_moments(stats: MomentStats, lamb: float = 0.1,
                             use_offset: bool = True,
                             use_ridge: bool = True,
                             sum_x2tx2: Optional[torch.Tensor] = None
                             ) -> RidgeSolution:
    """Solves the regularized normal equations from MomentStats
    (telluride_decoding_tpu/solvers/ridge.py:59-128)."""
    n = stats.count
    if use_offset:
        szz, szy = _augmented_moments(stats)
    else:
        szz, szy = stats.sxx, stats.sxy
    cov_x = szz / n
    cov_xy = szy / n
    n_col = cov_x.shape[0]
    eye = torch.eye(n_col, dtype=cov_x.dtype, device=cov_x.device)

    mean_aug = (torch.cat([stats.sum_x, n.reshape(1)]) / n if use_offset
                else stats.sum_x / n)
    # The eigenvalue-mean target of the Blankertz/LW blend comes from the
    # normalized centered covariance, as in the JAX package (which
    # deliberately departs from the reference's unnormalized scatter).
    czc = szz / n - torch.outer(mean_aug, mean_aug)
    mu_n = torch.trace(czc) / n_col

    lamb = torch.as_tensor(lamb, dtype=cov_x.dtype, device=cov_x.device)
    if use_ridge:
        cov_r = cov_x + lamb * eye
        shrinkage = lamb
    else:
        if sum_x2tx2 is not None:
            # Ledoit-Wolf automatic shrinkage (sklearn's normalization),
            # clipped to [0, 1]; taken where lamb == -1.
            delta = torch.sum((czc - mu_n * eye) ** 2) / n_col
            beta_ = (torch.sum(sum_x2tx2) / n -
                     torch.sum(czc ** 2)) / (n_col * n)
            beta = torch.minimum(beta_, delta)
            auto = torch.clamp(beta / torch.clamp(delta, min=1e-30), 0.0,
                               1.0)
            shrinkage = torch.where(lamb == -1, auto, lamb)
        else:
            # Without sum_x2tx2 the -1 sentinel cannot be honored: clamp
            # into the valid range (-1 becomes 0, no shrinkage).
            shrinkage = torch.clamp(lamb, 0.0, 1.0)
        cov_r = (1.0 - shrinkage) * cov_x + shrinkage * mu_n * eye

    solution = torch.linalg.solve(cov_r, cov_xy)
    if use_offset:
        w = solution[:-1, :]
        b = solution[-1, :]
    else:
        w = solution
        b = torch.zeros((szy.shape[1],), dtype=solution.dtype,
                        device=solution.device)
    return RidgeSolution(w=w, b=b, cov_x=cov_r, cov_xy=cov_xy,
                         shrinkage=shrinkage)


def calculate_linear_regressor_parameters(x: torch.Tensor, y: torch.Tensor,
                                          lamb: float = 0.1,
                                          use_offset: bool = True,
                                          use_ridge: bool = True,
                                          block: int = 8192
                                          ) -> RidgeSolution:
    """Ridge fit for in-memory [N, Dx] / [N, Dy] tensors
    (telluride_decoding_tpu/solvers/ridge.py:131-175). The Ledoit-Wolf
    path (lamb == -1) centers with the final mean."""
    if not use_ridge and lamb != -1 and not 0 <= lamb <= 1:
        raise ValueError('Regularization lambda must be between 0 and '
                         '1, not %g.' % lamb)
    x = x.float()
    y = y.float()
    if x.shape[0] > block:
        stats = blocked_moments(x, y, block=block)
    else:
        stats = moments_from_arrays(x, y)

    sum_x2tx2 = None
    # The O(N D^2) centered-squares pass only feeds the Ledoit-Wolf
    # automatic shrinkage.
    if not use_ridge and lamb == -1:
        xc2 = (x - (stats.sum_x / stats.count)[None, :]) ** 2
        if use_offset:
            # The augmented column of ones centers to zeros.
            xc2 = torch.cat([xc2, torch.zeros((x.shape[0], 1),
                                              dtype=x.dtype,
                                              device=x.device)], dim=1)
        sum_x2tx2 = xc2.T @ xc2

    return solve_ridge_from_moments(stats, lamb=lamb, use_offset=use_offset,
                                    use_ridge=use_ridge,
                                    sum_x2tx2=sum_x2tx2)
