"""Operations and bytes of the benchmark's work, from shapes alone.

Counts follow the plain algorithm, not what a kernel happens to do, so
that they stay fixed whatever a later change implements: each input byte
read once and each output byte written once; a multiply-add is two
operations; exp, log, sqrt and a division count one each.
"""

from __future__ import annotations

F32 = 4


def k1_bytes(rows: int, f1: int, f2: int, dims: int, calls: int = 1) -> int:
    """``calls`` pair calls of K1 over ``rows`` rows in all: the EEG rows
    and both talkers' rows, two scores a row, and a call's rotations and
    folded constants (c1, c2, scale: 3 D, and the intercept)."""
    return F32 * (rows * (f1 + 2 * f2 + 2) +
                  calls * ((f1 + f2) * dims + 3 * dims + 1))


def k1_flops(rows: int, f1: int, f2: int, dims: int) -> int:
    """One pair call: r1 once, r2 for each talker, and per talker and
    dimension two subtractions, two products and the sum."""
    return rows * (2 * f1 * dims + 2 * 2 * f2 * dims + 2 * 5 * dims)


def ssd_window_flops(k_w: int, outer: int = 20, inner: int = 1,
                     newton: int = 10) -> int:
    """One window update of the state-space decoder (reference/ssd.py),
    counted statement by statement."""
    e_step = k_w * (4 * 9 + 3 + 7)          # 4 densities, sigmoid, ep.
    m_step = 2 * k_w * 6 + 2 * k_w * 10 + 20   # 2 means, 2 precisions.
    newton_step = 12
    forward = k_w * (4 + newton * newton_step + 8)
    smoother = k_w * 9
    eta = k_w * 11
    return outer * (e_step + m_step + inner * (forward + smoother + eta))


def serve_push_flops(frames: int, windows: int, width: int, f1: int,
                     f2: int, dims: int, ssd_k_w: int = 0) -> int:
    """Model operations of pushes that decoded ``frames`` frames and
    decided ``windows`` windows: the decode of both talkers (K1's count),
    each window's two means, and for the state-space rule one update a
    window."""
    total = k1_flops(frames, f1, f2, dims) + windows * 2 * width
    if ssd_k_w:
        total += windows * ssd_window_flops(ssd_k_w)
    return total


def k2_bytes(rows: int, channels: int, lags: int) -> int:
    """One lag stack: the raw rows read, the stacked rows written."""
    return F32 * rows * channels * (1 + lags)


def sweep_flops(model: str, files: int, frames: int, fx: int, fy: int,
                lambdas: int) -> int:
    """One sweep by the plain algorithm: per-file moments of [x | y]
    (2 N F^2 over all frames), then per held-out file and lambda the
    factorisations and solves. Ridge: one Cholesky of the augmented
    (fx + 1) system and its two triangular solves. CCA: Choleskys of both
    covariances, the whitened cross-covariance (two triangular solves),
    its thin SVD (4 fx fy^2) and the two rotations."""
    f = fx + fy
    total = 2 * files * frames * f * f
    if model == 'ridge':
        n = fx + 1
        per_fit = n ** 3 // 3 + 2 * n * n
    else:
        per_fit = ((fx ** 3 + fy ** 3) // 3 + fx * fx * fy + fy * fy * fx +
                   4 * fx * fy * fy + fx * fx + fy * fy)
    return total + files * lambdas * per_fit
