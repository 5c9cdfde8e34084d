"""Plain reference of a leave-one-file-out sweep: the [lambda, file]
grid of held-out correlations, from the raw per-file streams.

It imports nothing of the program. Each file is lag-stacked here
(zeros outside the file's frames), its moments summed, and for each
held-out file f and each lambda:

  ridge:  z = [x, 1];  w = (Z'Z / n + lambda I)^-1 Z'y / n over the other
          files (n their frames); r = pearson(z_f w, y_f[:, 0]).
  cca:    cov = S / (n - 1) - mean mean' over the other files (the
          reference's normalisation quirk); L_x L_x' = cov_xx + lambda I,
          L_y likewise; the first singular pair (u, v) of
          L_x^-1 cov_xy L_y^-T; r = pearson(x_f L_x^-T u, y_f L_y^-T v).

The held-out r comes from the held-out file's own predictions, not from
its moments. ``precision`` as in reference/decode.py: 'float64', or the
control's float32 with TF32 products.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.precision import as_dtype, cholesky, matmul


def _stack(raw: np.ndarray, n: int, pre: int, post: int, dtype, device):
    """[n, C * (pre + 1 + post)] lag-major rows of frames t - pre .. t +
    post of a file's first n frames, zeros outside them."""
    x = torch.as_tensor(raw[:n], device=device).to(dtype)
    x = torch.nn.functional.pad(x, (0, 0, pre, post))
    return x.unfold(0, pre + 1 + post, 1).transpose(1, 2).reshape(n, -1)


def _pearson(a: torch.Tensor, b: torch.Tensor) -> float:
    a = a.double() - a.double().mean()
    b = b.double() - b.double().mean()
    return float((a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum()))


def file_moments(x, y, frames, lags, device, precision: str = 'float64'
                 ) -> dict:
    """One file's moments of its lag-stacked x and y, as float64 host
    arrays: count, sum_x, sum_y, sxx, syy, sxy."""
    dtype = as_dtype(precision)
    x_pre, x_post, y_pre, y_post = lags
    xf = _stack(x, frames, x_pre, x_post, dtype, device)
    yf = _stack(y, frames, y_pre, y_post, dtype, device)
    out = {'count': float(frames), 'sum_x': xf.sum(0), 'sum_y': yf.sum(0),
           'sxx': matmul(xf.T, xf, precision),
           'syy': matmul(yf.T, yf, precision),
           'sxy': matmul(xf.T, yf, precision)}
    return {k: v if isinstance(v, float) else v.double().cpu().numpy()
            for k, v in out.items()}


def grid(xs, ys, frames, lags, lambdas, model: str, device,
         precision: str = 'float64') -> np.ndarray:
    """[L, F] held-out correlations of one subject's files (xs, ys in the
    engine's raw layout, ``frames`` real frames each, ``lags`` (x_pre,
    x_post, y_pre, y_post))."""
    dtype = as_dtype(precision)
    x_pre, x_post, y_pre, y_post = lags
    files = []
    for x, y in zip(xs, ys):
        xf = _stack(x, frames, x_pre, x_post, dtype, device)
        yf = _stack(y, frames, y_pre, y_post, dtype, device)
        if model == 'ridge':
            xf = torch.cat([xf, torch.ones_like(xf[:, :1])], 1)
        zf = torch.cat([xf, yf], 1)
        # Moments of [x | y]: sums and the product matrix.
        files.append((xf, yf, zf.sum(0), matmul(zf.T, zf, precision)))
    total_sum = sum(f[2] for f in files)
    total_prod = sum(f[3] for f in files)
    dx = files[0][0].shape[1]
    eye_x = torch.eye(dx, dtype=dtype, device=device)
    out = np.zeros((len(lambdas), len(files)))
    lams = torch.as_tensor(np.asarray(lambdas, np.float64), device=device
                           ).to(dtype)
    for f, (xf, yf, zsum, zprod) in enumerate(files):
        n = float(frames * (len(files) - 1))
        s, m = total_sum - zsum, total_prod - zprod
        if model == 'ridge':
            # All lambdas of a held-out file in one batched solve.
            w = torch.cholesky_solve(
                (m[:dx, dx:] / n).expand(len(lambdas), dx, 1),
                cholesky(m[:dx, :dx] / n + lams[:, None, None] * eye_x,
                         precision))
            preds = matmul(xf, w[..., 0].T, precision)
            for i in range(len(lambdas)):
                out[i, f] = _pearson(preds[:, i], yf[:, 0])
            continue
        mean = s / n
        cov = m / (n - 1) - torch.outer(mean, mean)
        dy = cov.shape[0] - dx
        eye_y = torch.eye(dy, dtype=dtype, device=device)
        for i, lamb in enumerate(lambdas):
            lx = cholesky(cov[:dx, :dx] + lamb * eye_x, precision)
            ly = cholesky(cov[dx:, dx:] + lamb * eye_y, precision)
            t = torch.linalg.solve_triangular(lx, cov[:dx, dx:],
                                              upper=False)
            t = torch.linalg.solve_triangular(ly, t.T, upper=False).T
            u, _, vt = torch.linalg.svd(t, full_matrices=False)
            rot_x = torch.linalg.solve_triangular(lx.T, u[:, :1],
                                                  upper=True)
            rot_y = torch.linalg.solve_triangular(ly.T, vt[:1].T,
                                                  upper=True)
            out[i, f] = _pearson(matmul(xf, rot_x, precision)[:, 0],
                                 matmul(yf, rot_y, precision)[:, 0])
    return out
