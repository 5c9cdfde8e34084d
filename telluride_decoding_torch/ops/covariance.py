"""Second-moment accumulation (port of ops/covariance.py).

The products are plain large float32 matmuls, which the JAX package ran
outside any Pallas kernel at Precision.HIGHEST; here they are
torch.matmul with TF32 off (telluride_decoding_torch.device).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class MomentStats(NamedTuple):
    """Sufficient statistics for (cross-)covariance based solvers.

    All sums are over frames (axis 0) and unnormalized:
      count  : scalar number of frames
      sum_x  : [Dx]           sum of x
      sum_y  : [Dy]           sum of y
      sxx    : [Dx, Dx]       sum of x^T x
      syy    : [Dy, Dy]       sum of y^T y  (zeros unless asked for)
      sxy    : [Dx, Dy]       sum of x^T y
    """

    count: torch.Tensor
    sum_x: torch.Tensor
    sum_y: torch.Tensor
    sxx: torch.Tensor
    syy: torch.Tensor
    sxy: torch.Tensor

    def __add__(self, other: 'MomentStats') -> 'MomentStats':
        return MomentStats(*(a + b for a, b in zip(self, other)))

    @property
    def mean_x(self) -> torch.Tensor:
        return self.sum_x / self.count

    @property
    def mean_y(self) -> torch.Tensor:
        return self.sum_y / self.count

    # No centered() helper, as in the JAX package: the solvers normalize
    # with the reference's own (quirky) algebra.


def zeros_moments(dx: int, dy: int, device) -> MomentStats:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return MomentStats(z(), z(dx), z(dy), z(dx, dx), z(dy, dy), z(dx, dy))


def pad_to_bucket(arrays: Sequence[np.ndarray], n: int, bucket: int
                  ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Zero-pads host [N_i, D] arrays to the next multiple of ``bucket``
    rows (telluride_decoding_tpu/ops/covariance.py:71-91); returns the
    float32 padded arrays and the [padded] 0/1 mask of the first ``n``
    rows. Files of similar length then share one shape, so the caching
    allocator reuses their blocks; the mask keeps masked sums exact."""
    padded_n = -(-max(n, 1) // bucket) * bucket
    out = []
    for a in arrays:
        p = np.zeros((padded_n, a.shape[1]), np.float32)
        p[:n] = np.asarray(a[:n], np.float32)
        out.append(p)
    return out, (np.arange(padded_n) < n).astype(np.float32)


def _chunk_moments(x: torch.Tensor, y: torch.Tensor,
                   want_syy: bool) -> MomentStats:
    x = x.float()
    y = y.float()
    syy = (y.T @ y if want_syy else
           torch.zeros((y.shape[1], y.shape[1]), dtype=torch.float32,
                       device=y.device))
    return MomentStats(
        count=torch.tensor(float(x.shape[0]), device=x.device),
        sum_x=x.sum(0), sum_y=y.sum(0), sxx=x.T @ x, syy=syy, sxy=x.T @ y)


def moments_from_arrays(x: torch.Tensor, y: torch.Tensor, *,
                        want_syy: bool = False) -> MomentStats:
    """One-shot moment computation for in-memory [N, D] tensors."""
    return _chunk_moments(x, y, want_syy)


def blocked_moments(x: torch.Tensor, y: torch.Tensor, *,
                    block: int = 8192, want_syy: bool = False,
                    valid: Optional[torch.Tensor] = None) -> MomentStats:
    """Moment accumulation over blocks of ``block`` frames.

    Peak memory stays at O(block * D) on top of the inputs. ``valid`` is
    an optional [N] 0/1 mask; frames with 0 are excluded from every sum
    and from the count.
    """
    n, dx = x.shape
    total = zeros_moments(dx, y.shape[1], x.device)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.float32, device=x.device)
    valid = valid.float()
    for start in range(0, n, block):
        v = valid[start:start + block, None]
        stats = _chunk_moments(x[start:start + block].float() * v,
                               y[start:start + block].float() * v,
                               want_syy)
        total = total + stats._replace(count=v.sum())
    return total
