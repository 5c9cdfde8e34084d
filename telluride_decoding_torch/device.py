"""Device and precision policy of the port.

The JAX package asks for ``Precision.HIGHEST`` in its moment, pearson
and solver products (telluride_decoding_tpu/ops/covariance.py:100-115,
solvers/cca.py:93-101). On the card a float32 product may run in TF32,
which keeps about three decimal digits, so every CUDA device handed out
here comes with TF32 off for matmuls and cuDNN. There is no silent CPU
fallback: asking for CUDA without a card raises.
"""

from __future__ import annotations

import numpy as np
import torch


def full_fp32() -> None:
    """Runs every float32 matmul and convolution in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA device ``index`` with the precision policy applied."""
    if not torch.cuda.is_available():
        raise RuntimeError('No CUDA device is available; the port runs '
                           'its main path on the GPU only.')
    full_fp32()
    return torch.device('cuda', index)


def resolve(device) -> torch.device:
    """``torch.device`` for a name or device; CUDA goes via cuda_device."""
    device = torch.device(device)
    if device.type == 'cuda':
        return cuda_device(0 if device.index is None else device.index)
    return device


def as_tensor(value, device, dtype=None) -> torch.Tensor:
    """``value`` (array, number or tensor) as a tensor on ``device``.

    A read-only numpy array (a stride-trick view, say) is copied first:
    torch cannot share memory it may not write.
    """
    if not isinstance(value, torch.Tensor):
        value = np.asarray(value)
        if not value.flags.writeable:
            value = value.copy()
    return torch.as_tensor(value, device=device).to(dtype=dtype)
