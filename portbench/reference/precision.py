"""The references' two precisions: float64, and the control's TF32.

TF32 keeps 10 of float32's 23 mantissa bits in a product's operands and
accumulates in float32. ``tf32`` rounds a float32 tensor to it (to
nearest, ties away from zero) so that the control computes alike on the
CPU and on a card. In the control a Cholesky factorisation is TF32 too:
its trailing updates, nearly all of its operations, are TF32 products.
"""

from __future__ import annotations

import torch

PRECISIONS = ('float64', 'tf32')


def as_dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError('precision %r is not one of %s' % (precision,
                                                            PRECISIONS))
    return torch.float64 if precision == 'float64' else torch.float32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's mantissa."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str
           ) -> torch.Tensor:
    """a @ b in the precision: float64, or TF32 products."""
    if precision == 'tf32':
        return tf32(a) @ tf32(b)
    return a @ b


CHOLESKY_BLOCK = 128


def cholesky(a: torch.Tensor, precision: str) -> torch.Tensor:
    """Lower Cholesky factors of a batch: LAPACK's in float64; in 'tf32'
    a right-looking blocked factorisation whose trailing updates are
    TF32 products (diagonal blocks and panels in float32)."""
    if precision != 'tf32':
        return torch.linalg.cholesky(a)
    a = a.clone()
    n = a.shape[-1]
    for j in range(0, n, CHOLESKY_BLOCK):
        e = min(n, j + CHOLESKY_BLOCK)
        l11 = torch.linalg.cholesky(a[..., j:e, j:e])
        a[..., j:e, j:e] = l11
        if e < n:
            # L21 L11' = A21.
            l21 = torch.linalg.solve_triangular(
                l11.transpose(-1, -2), a[..., e:, j:e], upper=True,
                left=False)
            a[..., e:, j:e] = l21
            a[..., e:, e:] -= matmul(l21, l21.transpose(-1, -2), precision)
    return torch.tril(a)
