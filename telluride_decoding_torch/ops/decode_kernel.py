"""Fused CCA decode (port of ops/decode_kernel.py).

Per window of x1 [W, T, F1] and x2 [W, T, F2]:

  r1 = x1 @ rot1, r2 = x2 @ rot2            (fp32 accumulation)
  out = mean_t sum_d (r1 - c1) * (r2 - c2) * scale + intercept

with the folded parameters c1 = mean1 @ rot1 + corr_mean_x,
c2 = mean2 @ rot2 + corr_mean_y and scale = lda_slope * lda_w[:, 0] /
corr_power (telluride_decoding_tpu/ops/decode_kernel.py:53-70). This is
the serving decode of a CCA model with the LDA reduction: per-frame
scores are windows of T = 1.

  * fused_cca_decode_reference: plain torch (decode_kernel.py:73-81).
  * fused_cca_decode: wrapper of kernel K1 (csrc/decode_kernel.cu), which
    replaces the Pallas kernel of the same name. It also takes a second
    x2 stream and scores both against one read of x1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from telluride_decoding_torch import kernels

MAX_DIMS = 16
# Dynamic shared memory one block may opt into on sm_90 (227 KB).
_MAX_SMEM_BYTES = 232448
# Must match kWarps in csrc/decode_kernel.cu.
_KERNEL_WARPS = 8
# A block takes at least this many rows (frames), so that staging the
# rotations in shared memory is paid for by enough rows of x1.
_MIN_ROWS_PER_BLOCK = 32
_MAX_WINDOWS_PER_BLOCK = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class FoldedDecode(NamedTuple):
    """Decode parameters in kernel form, all float32 on one device."""

    rot1: torch.Tensor       # [F1, D]
    rot2: torch.Tensor       # [F2, D]
    c1: torch.Tensor         # [D]
    c2: torch.Tensor         # [D]
    scale: torch.Tensor      # [D]
    intercept: torch.Tensor  # scalar


def fold_decode_params(params) -> FoldedDecode:
    """Folds the CCA + LDA parameters into kernel form.

    ``params`` uses the bench schema of the JAX package: mean1/mean2
    [1, F*], rot1/rot2 [F*, D], corr_mean_x/y [D], corr_power [D],
    lda_w [D, k], lda_slope and lda_intercept (scalars), as tensors on
    one device (scalars may be numbers).
    """
    rot1 = params['rot1'].float()
    rot2 = params['rot2'].float()
    device = rot1.device

    def vec(name):
        return torch.as_tensor(params[name], dtype=torch.float32,
                               device=device)
    c1 = (vec('mean1') @ rot1).reshape(-1) + vec('corr_mean_x')
    c2 = (vec('mean2') @ rot2).reshape(-1) + vec('corr_mean_y')
    scale = vec('lda_slope') * vec('lda_w')[:, 0] / vec('corr_power')
    return FoldedDecode(rot1, rot2, c1, c2, scale, vec('lda_intercept'))


def _rotate(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    # The rotation is rounded to x's dtype, as the JAX decode does; the
    # product is then taken in float32, which holds every bf16 x bf16
    # product exactly (JAX's preferred_element_type=float32).
    return torch.einsum('wtf,fd->wtd', x.float(), rot.to(x.dtype).float())


def fused_cca_decode_reference(folded: FoldedDecode, x1: torch.Tensor,
                               x2: torch.Tensor) -> torch.Tensor:
    """Plain torch semantics: [W, T, F1] / [W, T, F2] -> [W] scores."""
    r1 = _rotate(x1, folded.rot1) - folded.c1
    r2 = _rotate(x2, folded.rot2) - folded.c2
    return torch.mean(torch.sum(r1 * r2 * folded.scale, dim=-1),
                      dim=1) + folded.intercept


def _windows_per_block(device, windows: int, frames: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    target = -(-windows // (2 * sms))           # About two blocks per SM.
    floor = -(-_MIN_ROWS_PER_BLOCK // frames)
    return max(1, min(max(target, floor), _MAX_WINDOWS_PER_BLOCK))


def fused_cca_decode(folded: FoldedDecode, x1: torch.Tensor,
                     x2: torch.Tensor,
                     x2b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused decode: kernel K1 on CUDA.

    Returns [W] scores, or [2, W] (one row per x2 stream) when ``x2b``
    is given. CPU tensors take fused_cca_decode_reference. CUDA tensors
    launch the kernel once or raise: inputs must be contiguous float32
    or bfloat16 of one dtype, on the device of the folded parameters,
    with D <= 16.
    """
    streams = [x2] if x2b is None else [x2, x2b]
    if x1.device.type == 'cpu':
        scores = [fused_cca_decode_reference(folded, x1, s) for s in streams]
        return scores[0] if x2b is None else torch.stack(scores)
    tensors = [x1, *streams, *folded]
    if any(t.device != x1.device for t in tensors) or \
            x1.device.type != 'cuda':
        raise ValueError('fused_cca_decode needs every tensor on one CUDA '
                         'device, got %s.'
                         % sorted({str(t.device) for t in tensors}))
    if x1.dtype not in _DTYPE_CODES or any(s.dtype != x1.dtype
                                           for s in streams):
        raise ValueError('fused_cca_decode takes float32 or bfloat16 x1 '
                         'and x2 of one dtype, got %s.'
                         % [str(t.dtype) for t in (x1, *streams)])
    if not all(t.is_contiguous() for t in (x1, *streams)):
        raise ValueError('fused_cca_decode needs contiguous inputs.')
    if any(t.dim() != 3 for t in (x1, *streams)):
        raise ValueError('fused_cca_decode takes [W, T, F] windows.')
    f1, d = folded.rot1.shape
    f2 = folded.rot2.shape[0]
    if d > MAX_DIMS or d < 1:
        raise ValueError('fused_cca_decode supports 1..%d dims, not %d.'
                         % (MAX_DIMS, d))
    windows, frames = x1.shape[:2]
    if x1.shape[2] != f1 or any(tuple(s.shape) != (windows, frames, f2)
                                for s in streams):
        raise ValueError('fused_cca_decode shapes do not match: x1 %s, '
                         'x2 %s, rot1 %s, rot2 %s.'
                         % (tuple(x1.shape),
                            [tuple(s.shape) for s in streams],
                            tuple(folded.rot1.shape),
                            tuple(folded.rot2.shape)))
    if frames < 1:
        raise ValueError('fused_cca_decode needs T >= 1 frames.')
    out = torch.empty((len(streams), windows), dtype=torch.float32,
                      device=x1.device)
    if windows == 0:
        return out[0] if x2b is None else out
    wpb = _windows_per_block(x1.device, windows, frames)
    smem = 4 * (3 * d + 1 + d * (f1 + f2) + 2 * _KERNEL_WARPS * wpb)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError('fused_cca_decode: rotations of %d x %d and %d x '
                         '%d need %d bytes of shared memory, more than a '
                         'block has (%d).'
                         % (f1, d, f2, d, smem, _MAX_SMEM_BYTES))
    # Rotations rounded to x's dtype (JAX casts them at
    # decode_kernel.py:177), widened back to float32 and transposed to
    # [D, F] so a warp's lanes read consecutive shared-memory words.
    rot1_t = folded.rot1.to(x1.dtype).float().t().contiguous()
    rot2_t = folded.rot2.to(x1.dtype).float().t().contiguous()
    consts = torch.cat([folded.c1, folded.c2, folded.scale,
                        folded.intercept.reshape(1)]).contiguous()
    lib = kernels.library()
    kernels.check(lib.tdt_fused_cca_decode(
        x1.data_ptr(), x2.data_ptr(),
        None if x2b is None else x2b.data_ptr(),
        rot1_t.data_ptr(), rot2_t.data_ptr(), consts.data_ptr(),
        out[0].data_ptr(), None if x2b is None else out[1].data_ptr(),
        windows, frames, f1, f2, d, _DTYPE_CODES[x1.dtype], wpb,
        kernels.stream_handle(x1.device)), 'fused_cca_decode')
    fused_cca_decode.launches += 1
    return out[0] if x2b is None else out


fused_cca_decode.launches = 0
