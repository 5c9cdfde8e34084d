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
    x2 stream and scores both against one read of x1. bf16 windows go
    to the tensor-core kernel, float32 ones (the serving path) to the
    CUDA-core kernel.
  * prepared_operands: the rotations and constants in each kernel's
    form, kept per parameter set and dtype so a served chunk does not
    rebuild them; pack_mma_b is the bf16 B-operand packing it uses.
"""

from __future__ import annotations

import collections
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
_DTYPES = (torch.float32, torch.bfloat16)
# The tensor-core kernel (must match namespace mma in
# csrc/decode_kernel.cu): groups of 16 rows, two n8 tiles (D <= 16),
# k-steps of 16 features, at most 24 k-steps a warp per chunk of the
# feature axis, so a chunk holds at most 3072 features.
MMA_ROWS = 16
MMA_COLS = 16
MMA_STEP = 16
_MMA_MAX_CHUNK = _KERNEL_WARPS * 24 * MMA_STEP
_MMA_PITCH_PAD = 16
# Prepared operands kept (see prepared_operands).
_PREPARED_SIZE = 16
_prepared = collections.OrderedDict()


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


def pack_mma_b(rot: torch.Tensor) -> torch.Tensor:
    """rot [F, D] as the B operand of mma.m16n8k16 (bf16, D <= 16).

    rot is rounded to bf16 and zero-padded to [K, 16], K = F rounded up
    to 16, then laid out per k-step s in fragment order: [K / 16, 32, 8],
    where lane l = 4 g + c holds, for the n8 tiles t = 0, 1, column
    8 t + g at rows 16 s + 4 c .. 16 s + 4 c + 3. A lane then loads its
    four B registers of one k-step with one 16-byte load. Those rows are
    the fragment's k = 2c, 2c + 1, 2c + 8, 2c + 9: the kernel permutes the
    features of a step so that a lane's A elements of a row are four
    consecutive ones, and B follows the same permutation.
    """
    f, d = rot.shape
    k = -(-f // MMA_STEP) * MMA_STEP
    padded = torch.zeros((k, MMA_COLS), dtype=torch.bfloat16,
                         device=rot.device)
    padded[:f, :d] = rot.to(torch.bfloat16)
    # [step, c, i, t, g] -> [step, g, c, t, i]: lane 4 g + c, slot 4 t + i.
    return padded.reshape(k // MMA_STEP, 4, 4, 2, 8).permute(
        0, 4, 1, 3, 2).reshape(k // MMA_STEP, 32, 8).contiguous()


class PreparedOperands(NamedTuple):
    """One kernel's rotations and constants, float32 unless stated.

    float32 inputs (CUDA-core kernel): rot1 [D, F1], rot2 [D, F2] and
    consts [c1 (D), c2 (D), scale (D), intercept]. bf16 inputs
    (tensor-core kernel): rot1 and rot2 through pack_mma_b (bf16) and
    consts [c1, c2, scale (each padded to 16), intercept].
    Both rotations are rounded to the inputs' dtype first, as the JAX
    decode does (decode_kernel.py:177).
    """

    rot1: torch.Tensor
    rot2: torch.Tensor
    consts: torch.Tensor


def _prepare(folded: FoldedDecode, dtype: torch.dtype) -> PreparedOperands:
    vectors = (folded.c1, folded.c2, folded.scale)
    if dtype == torch.float32:
        # [D, F] so a warp's lanes read consecutive shared-memory words.
        return PreparedOperands(
            folded.rot1.t().contiguous(), folded.rot2.t().contiguous(),
            torch.cat([*vectors, folded.intercept.reshape(1)]).contiguous())
    d = folded.rot1.shape[1]
    consts = torch.zeros(3 * MMA_COLS + 1, device=folded.rot1.device)
    for i, v in enumerate(vectors):
        consts[i * MMA_COLS:i * MMA_COLS + d] = v
    consts[-1] = folded.intercept
    return PreparedOperands(pack_mma_b(folded.rot1), pack_mma_b(folded.rot2),
                            consts)


def _tensor_key(t: torch.Tensor):
    return (t.data_ptr(), t._version, tuple(t.shape), t.dtype, str(t.device))


def prepared_operands(folded: FoldedDecode,
                      dtype: torch.dtype) -> PreparedOperands:
    """The kernel operands for ``folded`` and inputs of ``dtype``.

    Kept in an LRU of the last few parameter sets, keyed by each folded
    tensor's address, version counter, shape and dtype: a refit (new
    tensors) or an in-place edit (a new version) gives a new entry. An
    entry holds the folded tensors too, so no new tensor can take the
    address of a cached one while the entry lives.
    """
    key = (dtype, *(_tensor_key(t) for t in folded))
    hit = _prepared.get(key)
    if hit is not None:
        _prepared.move_to_end(key)
        return hit[1]
    operands = _prepare(folded, dtype)
    _prepared[key] = (folded, operands)
    while len(_prepared) > _PREPARED_SIZE:
        _prepared.popitem(last=False)
    return operands


def _windows_per_block(device, windows: int, frames: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    target = -(-windows // (2 * sms))           # About two blocks per SM.
    floor = -(-_MIN_ROWS_PER_BLOCK // frames)
    return max(1, min(max(target, floor), _MAX_WINDOWS_PER_BLOCK))


def mma_smem_bytes(chunk: int, f2: int, windows_per_block: int) -> int:
    """Dynamic shared memory of the tensor-core kernel (layout() in
    csrc/decode_kernel.cu): two stages of 16 x1 rows of ``chunk``
    features and of 16 rows of each x2 stream, the warps' partial r1
    tiles, the r2 tiles, the stages' two barriers, rot2's fragments, the
    constants, row scores and window sums."""
    x1_stage = MMA_ROWS * (chunk + _MMA_PITCH_PAD) * 2
    x2_stage = (MMA_ROWS * f2 * 2 + 29) // 16 * 16
    tile = MMA_ROWS * MMA_COLS * 4
    return (2 * x1_stage + 4 * x2_stage + (_KERNEL_WARPS + 2) * tile + 16
            + -(-f2 // MMA_STEP) * 32 * 16 + (3 * MMA_COLS + 1) * 4
            + 2 * MMA_ROWS * 4 + 2 * windows_per_block * 4)


def mma_plan(f1: int, f2: int, windows: int, sms: int):
    """(chunk, windows_per_block, shared bytes) of the tensor-core kernel.

    A block owns whole windows, ceil(W / #SMs) of them (at most 1024),
    so about one block runs on each SM and no score crosses blocks. The
    feature axis is walked in chunks of a multiple of 128 features (8
    warps x k-steps of 16), as wide as F1 up to 3072 and narrowed until
    two stages fit in shared memory.
    """
    wpb = max(1, min(-(-windows // sms), _MAX_WINDOWS_PER_BLOCK))
    unit = _KERNEL_WARPS * MMA_STEP
    chunk = min(_MMA_MAX_CHUNK, max(unit, -(-f1 // unit) * unit))
    while mma_smem_bytes(chunk, f2, wpb) > _MAX_SMEM_BYTES and chunk > unit:
        chunk -= unit
    smem = mma_smem_bytes(chunk, f2, wpb)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError('fused_cca_decode: x2 rows of %d features need %d '
                         'bytes of shared memory, more than a block has '
                         '(%d).' % (f2, smem, _MAX_SMEM_BYTES))
    return chunk, wpb, smem


def fused_cca_decode(folded: FoldedDecode, x1: torch.Tensor,
                     x2: torch.Tensor,
                     x2b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused decode: kernel K1 on CUDA.

    Returns [W] scores, or [2, W] (one row per x2 stream) when ``x2b``
    is given. CPU tensors take fused_cca_decode_reference. CUDA tensors
    launch a kernel once or raise: inputs must be contiguous float32
    (CUDA-core kernel) or bfloat16 (tensor-core kernel) of one dtype, on
    the device of the folded parameters, with D <= 16.
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
    if x1.dtype not in _DTYPES or any(s.dtype != x1.dtype for s in streams):
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
    if x1.dtype == torch.bfloat16:
        sms = torch.cuda.get_device_properties(
            x1.device).multi_processor_count
        chunk, wpb, _ = mma_plan(f1, f2, windows, sms)
    else:
        wpb = _windows_per_block(x1.device, windows, frames)
        smem = 4 * (3 * d + 1 + d * (f1 + f2) + 2 * _KERNEL_WARPS * wpb)
        if smem > _MAX_SMEM_BYTES:
            raise ValueError('fused_cca_decode: rotations of %d x %d and %d '
                             'x %d need %d bytes of shared memory, more than '
                             'a block has (%d).'
                             % (f1, d, f2, d, smem, _MAX_SMEM_BYTES))
    operands = prepared_operands(folded, x1.dtype)
    lib = kernels.library()
    pointers = (x1.data_ptr(), x2.data_ptr(),
                None if x2b is None else x2b.data_ptr(),
                *(t.data_ptr() for t in operands),
                out[0].data_ptr(), None if x2b is None else out[1].data_ptr())
    stream = kernels.stream_handle(x1.device)
    if x1.dtype == torch.bfloat16:
        code = lib.tdt_fused_cca_decode_bf16(
            *pointers, windows, frames, f1, f2, d, chunk, wpb, stream)
    else:
        code = lib.tdt_fused_cca_decode(*pointers, windows, frames, f1, f2,
                                        d, wpb, stream)
    kernels.check(code, 'fused_cca_decode')
    fused_cca_decode.launches += 1
    return out[0] if x2b is None else out


fused_cca_decode.launches = 0
