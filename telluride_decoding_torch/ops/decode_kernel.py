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
    cluster kernel, whose launch plan f32_plan computes.
  * prepared_operands: the rotations and constants in each kernel's
    form, kept per parameter set and dtype so a served chunk does not
    rebuild them; pack_mma_b is the bf16 B-operand packing it uses.
  * fused_cca_decode_f32: the float32 cluster kernel as the PyTorch op
    tdt::fused_cca_decode_f32 on the operands of kernel_operands, so
    that torch.export keeps K1 as one node of an exported program
    (decode/aot.py); it launches through fused_cca_decode's own launch
    code and counts as its launch (``kernels.launches``).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Callable, NamedTuple, Optional

import torch

from telluride_decoding_torch import kernels

MAX_DIMS = 16
# Dynamic shared memory one block may opt into on sm_90 (227 KB), of the
# SM's 228 KB, of which the runtime reserves 1 KB a block.
_MAX_SMEM_BYTES = 232448
_SM_SMEM_BYTES = 233472
_BLOCK_SMEM_RESERVED = 1024
# Must match mma::kWarps in csrc/decode_kernel.cu.
_KERNEL_WARPS = 8
_MAX_WINDOWS_PER_BLOCK = 1024
# The float32 cluster kernel (must match namespace f32 in
# csrc/decode_kernel.cu): rows walked in groups of 32, all products in 16
# columns (D zero-padded).
F32_GROUP = 32
F32_COLS = 16
# Largest cluster the plan takes: 16 (non-portable), which beat 8 (the
# portable size) on the serving pair in device time (PERF.md, PR 5).
F32_MAX_CLUSTER = 16
# Features of a block's slice staged at a time.
F32_MAX_CHUNK = 320
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
# Checked launches per call signature (see _launch_plan), and the SM
# count per device index.
_PLANS_SIZE = 256
_plans = {}
_sms = {}


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

    float32 inputs (cluster kernel): rot1 [F1, 16] and rot2 [F2, 16],
    zero past column D, and consts [c1, c2, scale (each padded to 16),
    intercept]. bf16 inputs (tensor-core kernel):
    rot1 and rot2 through pack_mma_b (bf16) and consts [c1, c2, scale
    (each padded to 16), intercept]. Both rotations are rounded to the
    inputs' dtype first, as the JAX decode does (decode_kernel.py:177).
    ``pointers`` are the three tensors' addresses.
    """

    rot1: torch.Tensor
    rot2: torch.Tensor
    consts: torch.Tensor
    pointers: tuple


class F32Plan(ctypes.Structure):
    """The float32 kernel's shape and launch plan (F32Plan in
    csrc/decode_kernel.cu, the same fields in the same order), built once
    per call signature. One pointer to it replaces nine ctypes arguments
    a call."""

    _fields_ = [(name, ctypes.c_int) for name in (
        'windows', 'frames', 'f1', 'f2', 'd', 'cluster', 'windows_per_tile',
        'slice', 'chunk')]


def _padded_consts(folded: FoldedDecode, cols: int) -> torch.Tensor:
    d = folded.rot1.shape[1]
    consts = torch.zeros(3 * cols + 1, device=folded.rot1.device)
    for i, v in enumerate((folded.c1, folded.c2, folded.scale)):
        consts[i * cols:i * cols + d] = v
    consts[-1] = folded.intercept
    return consts


def _padded_columns(rot: torch.Tensor, cols: int) -> torch.Tensor:
    out = torch.zeros((rot.shape[0], cols), device=rot.device)
    out[:, :rot.shape[1]] = rot
    return out


def _prepare(folded: FoldedDecode, dtype: torch.dtype) -> PreparedOperands:
    # Launch plans are kept per rot1 device; the rest must share it.
    if any(t.device != folded.rot1.device for t in folded):
        raise ValueError('fused_cca_decode needs the folded parameters on one '
                         'device, got %s.'
                         % sorted({str(t.device) for t in folded}))
    if dtype == torch.float32:
        # A feature's 16 columns are 64 aligned bytes: a block's slice of
        # features is one contiguous run of 16-byte copies.
        tensors = (_padded_columns(folded.rot1, F32_COLS),
                   _padded_columns(folded.rot2, F32_COLS),
                   _padded_consts(folded, F32_COLS))
    else:
        tensors = (pack_mma_b(folded.rot1), pack_mma_b(folded.rot2),
                   _padded_consts(folded, MMA_COLS))
    return PreparedOperands(*tensors, tuple(t.data_ptr() for t in tensors))


def prepared_operands(folded: FoldedDecode,
                      dtype: torch.dtype) -> PreparedOperands:
    """The kernel operands for ``folded`` and inputs of ``dtype``.

    Kept in an LRU of the last few parameter sets, keyed by the folded
    tuple's identity and each tensor's version counter: a refit (a new
    tuple) or an in-place edit (a new version) gives a new entry. An
    entry holds the folded tuple, so no new tuple can take the identity
    of a cached one while the entry lives.
    """
    key = (dtype, id(folded), *(t._version for t in folded))
    hit = _prepared.get(key)
    if hit is not None:
        _prepared.move_to_end(key)
        return hit[1]
    operands = _prepare(folded, dtype)
    _prepared[key] = (folded, operands)
    while len(_prepared) > _PREPARED_SIZE:
        _prepared.popitem(last=False)
    return operands


def f32_smem_bytes(chunk: int, f2: int, cluster: int,
                   windows_per_tile: int) -> int:
    """Dynamic shared memory of the float32 kernel (f32::layout() in
    csrc/decode_kernel.cu): two stages of a group's 32 rows of a chunk of
    the block's feature slice and of the chunk's rot1, the partial r1 the
    cluster's blocks send for this block's rows (two buffers), r2 of its
    rows, their x2 rows (both streams), rot2, the constants, row scores,
    the rows' indices and window sums."""
    pitch = (chunk + 3) // 4 * 4
    return (2 * F32_GROUP * pitch * 4 + 2 * chunk * F32_COLS * 4
            + 2 * F32_GROUP * cluster * F32_COLS * 4
            + F32_GROUP * 2 * F32_COLS * 4 + 2 * F32_GROUP * f2 * 4
            + f2 * F32_COLS * 4 + ((3 * F32_COLS + 1) * 4 + 15) // 16 * 16
            + 2 * F32_GROUP * 4 + F32_GROUP * 4 + 2 * windows_per_tile * 4)


def f32_plan(windows: int, frames: int, f1: int, f2: int, sms: int):
    """(cluster, windows_per_tile, slice, chunk, shared bytes) of the
    float32 kernel.

    A cluster of ``cluster`` blocks owns a tile of whole windows, as
    many as fit in 32 rows (one when a window is longer; its rows are
    then walked 32 at a time). Block k of the cluster takes features
    [k * slice, (k + 1) * slice) of every row, staged ``chunk`` features
    at a time in two alternating stages. The cluster is the smallest
    power of two that gives every SM a block (at most F32_MAX_CLUSTER):
    a served chunk of frames, one tile, spreads over the largest
    cluster, many tiles over small ones. The chunk is the slice up to
    F32_MAX_CHUNK features, narrowed by 32 until the blocks an SM must
    hold at once (one, or two when there are more blocks than SMs) fit
    in its shared memory.
    """
    wpt = max(1, F32_GROUP // frames)
    tiles = -(-windows // wpt)
    cluster = 1
    while cluster < F32_MAX_CLUSTER and tiles * cluster < sms:
        cluster *= 2
    per_sm = 1 if tiles * cluster <= sms else 2
    budget = min(_MAX_SMEM_BYTES,
                 _SM_SMEM_BYTES // per_sm - _BLOCK_SMEM_RESERVED)
    slice_ = -(-f1 // cluster)
    chunk = min(slice_, F32_MAX_CHUNK)
    while f32_smem_bytes(chunk, f2, cluster, wpt) > budget and chunk > 32:
        chunk = (chunk - 1) // 32 * 32
    smem = f32_smem_bytes(chunk, f2, cluster, wpt)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError('fused_cca_decode: x2 rows of %d features need %d '
                         'bytes of shared memory a block, more than a block '
                         'has (%d).' % (f2, smem, _MAX_SMEM_BYTES))
    return cluster, wpt, slice_, chunk, smem


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


class _Launch(NamedTuple):
    """A checked launch: the windows, the C entry point (None for no
    windows), its arguments after the pointers and, for float32, the
    F32Plan those arguments point to (kept alive here)."""

    windows: int
    entry: object
    args: tuple
    struct: Optional[F32Plan] = None


def _sm_count(device) -> int:
    sms = _sms.get(device.index)
    if sms is None:
        sms = _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sms


def _launch_plan(x1: torch.Tensor, x2: torch.Tensor,
                 x2b: Optional[torch.Tensor], rot1: torch.Tensor,
                 rot2: torch.Tensor, d: int, params) -> _Launch:
    """Checks what depends only on shapes, dtypes and devices, and plans
    the launch; raises ValueError on what no kernel takes. ``rot1`` and
    ``rot2`` give F1 and F2 (their first axes), ``params`` every
    parameter tensor, which must share x1's device."""
    streams = [x2] if x2b is None else [x2, x2b]
    tensors = [x1, *streams, *params]
    if any(t.device != x1.device for t in tensors) or \
            x1.device.type != 'cuda':
        raise ValueError('fused_cca_decode needs every tensor on one CUDA '
                         'device, got %s.'
                         % sorted({str(t.device) for t in tensors}))
    if x1.dtype not in _DTYPES or any(s.dtype != x1.dtype for s in streams):
        raise ValueError('fused_cca_decode takes float32 or bfloat16 x1 '
                         'and x2 of one dtype, got %s.'
                         % [str(t.dtype) for t in (x1, *streams)])
    if any(t.dim() != 3 for t in (x1, *streams)):
        raise ValueError('fused_cca_decode takes [W, T, F] windows.')
    f1, f2 = rot1.shape[0], rot2.shape[0]
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
                            tuple(rot1.shape), tuple(rot2.shape)))
    if frames < 1:
        raise ValueError('fused_cca_decode needs T >= 1 frames.')
    if windows == 0:
        return _Launch(0, None, ())
    sms = _sm_count(x1.device)
    lib = kernels.library()
    if x1.dtype == torch.bfloat16:
        chunk, wpb, _ = mma_plan(f1, f2, windows, sms)
        return _Launch(windows, lib.tdt_fused_cca_decode_bf16,
                       (windows, frames, f1, f2, d, chunk, wpb))
    cluster, wpt, slice_, chunk, _ = f32_plan(windows, frames, f1, f2, sms)
    struct = F32Plan(windows, frames, f1, f2, d, cluster, wpt, slice_, chunk)
    return _Launch(windows, lib.tdt_fused_cca_decode,
                   (ctypes.addressof(struct),), struct)


def _launch(x1: torch.Tensor, x2: torch.Tensor, x2b: Optional[torch.Tensor],
            rot1: torch.Tensor, rot2: torch.Tensor, d: int, params,
            operand_pointers: Callable[[], tuple]) -> torch.Tensor:
    """Launches kernel K1 once (or raises) for fused_cca_decode and the
    op fused_cca_decode_f32: the plan is kept per call signature, so a
    served chunk pays for the checks once; ``operand_pointers()`` gives
    the addresses of the rotations and constants in the kernel's form."""
    single = x2b is None
    key = (x1.shape, x2.shape, None if single else x2b.shape,
           x1.dtype, x2.dtype, None if single else x2b.dtype,
           x1.device, x2.device, None if single else x2b.device,
           rot1.shape, rot2.shape, rot1.device, d)
    plan = _plans.get(key)
    if plan is None:
        plan = _launch_plan(x1, x2, x2b, rot1, rot2, d, params)
        if len(_plans) >= _PLANS_SIZE:
            _plans.clear()
        _plans[key] = plan
    if not (x1.is_contiguous() and x2.is_contiguous()
            and (single or x2b.is_contiguous())):
        raise ValueError('fused_cca_decode needs contiguous inputs.')
    windows = plan.windows
    out = torch.empty((windows,) if single else (2, windows),
                      dtype=torch.float32, device=x1.device)
    if windows == 0:
        return out
    out_a = out.data_ptr()
    pointers = (x1.data_ptr(), x2.data_ptr(),
                None if single else x2b.data_ptr())
    outputs = (out_a, None if single else out_a + 4 * windows)
    code = plan.entry(*pointers, *operand_pointers(), *outputs, *plan.args,
                      kernels.stream_handle(x1.device))
    kernels.check(code, 'fused_cca_decode')
    return out


def fused_cca_decode(folded: FoldedDecode, x1: torch.Tensor,
                     x2: torch.Tensor,
                     x2b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused decode: kernel K1 on CUDA.

    Returns [W] scores, or [2, W] (one row per x2 stream) when ``x2b``
    is given. CPU tensors take fused_cca_decode_reference. CUDA tensors
    launch a kernel once or raise: inputs must be contiguous float32
    (cluster kernel) or bfloat16 (tensor-core kernel) of one dtype, on
    the device of the folded parameters, with D <= 16. The checks that
    depend only on shapes, dtypes and devices, and the launch plan, are
    kept per call signature, so a served chunk pays for them once.
    """
    single = x2b is None
    if x1.device.type == 'cpu':
        scores = [fused_cca_decode_reference(folded, x1, s)
                  for s in ([x2] if single else [x2, x2b])]
        return scores[0] if single else torch.stack(scores)
    return _launch(x1, x2, x2b, folded.rot1, folded.rot2,
                   folded.rot1.shape[1], folded,
                   lambda: prepared_operands(folded, x1.dtype).pointers)


def kernel_operands(folded: FoldedDecode) -> tuple:
    """(rot1, rot2, consts) of ``folded`` in the float32 kernel's form
    (PreparedOperands), new tensors that the caller owns: what the op
    fused_cca_decode_f32 takes."""
    return tuple(_prepare(folded, torch.float32)[:3])


def _folded_from_operands(rot1: torch.Tensor, rot2: torch.Tensor,
                          consts: torch.Tensor, dims: int) -> FoldedDecode:
    """The FoldedDecode whose kernel form the operands are."""
    cols = rot1.shape[1]
    return FoldedDecode(rot1[:, :dims].contiguous(),
                        rot2[:, :dims].contiguous(), consts[:dims],
                        consts[cols:cols + dims],
                        consts[2 * cols:2 * cols + dims], consts[3 * cols])


def _check_operands(rot1: torch.Tensor, rot2: torch.Tensor,
                    consts: torch.Tensor, dims: int):
    if not (rot1.dim() == rot2.dim() == 2
            and rot1.shape[1] == rot2.shape[1] == F32_COLS
            and tuple(consts.shape) == (3 * F32_COLS + 1,)):
        raise ValueError('fused_cca_decode_f32 takes rot1 [F1, %d], rot2 '
                         '[F2, %d] and consts [%d] (kernel_operands), got '
                         '%s, %s and %s.'
                         % (F32_COLS, F32_COLS, 3 * F32_COLS + 1,
                            tuple(rot1.shape), tuple(rot2.shape),
                            tuple(consts.shape)))
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in (rot1, rot2, consts)):
        raise ValueError('fused_cca_decode_f32 takes contiguous float32 '
                         'operands.')
    if not 1 <= dims <= F32_COLS:
        raise ValueError('fused_cca_decode supports 1..%d dims, not %d.'
                         % (MAX_DIMS, dims))


@torch.library.custom_op('tdt::fused_cca_decode_f32', mutates_args=(),
                         device_types='cpu')
def fused_cca_decode_f32(x1: torch.Tensor, x2a: torch.Tensor,
                         x2b: Optional[torch.Tensor], rot1: torch.Tensor,
                         rot2: torch.Tensor, consts: torch.Tensor,
                         dims: int) -> torch.Tensor:
    """K1 as a PyTorch operator, so that an exported program
    (torch.export, decode/aot.py) holds the fused decode as one node.

    Float32 windows x1 [W, T, F1], x2a and an optional x2b [W, T, F2],
    the operands of ``kernel_operands`` and D, the count of their
    columns that are real (the rest are zero): [W] scores, or [2, W]
    with x2b. D is what the live decoder's launch plan holds, so the op
    makes the very launch fused_cca_decode makes on the same parameters.
    CUDA tensors launch the float32 cluster kernel through the launch
    code of fused_cca_decode (its plan cache, checks and launch count)
    or raise; CPU tensors take fused_cca_decode_reference.
    """
    _check_operands(rot1, rot2, consts, dims)
    folded = _folded_from_operands(rot1, rot2, consts, dims)
    scores = [fused_cca_decode_reference(folded, x1, s)
              for s in ([x2a] if x2b is None else [x2a, x2b])]
    return scores[0] if x2b is None else torch.stack(scores)


@fused_cca_decode_f32.register_kernel('cuda')
def _fused_cca_decode_f32_cuda(x1, x2a, x2b, rot1, rot2, consts, dims):
    _check_operands(rot1, rot2, consts, dims)
    if x1.dtype != torch.float32:
        raise ValueError('fused_cca_decode_f32 takes float32 windows, got '
                         '%s.' % x1.dtype)
    return _launch(x1, x2a, x2b, rot1, rot2, dims, (rot1, rot2, consts),
                   lambda: (rot1.data_ptr(), rot2.data_ptr(),
                            consts.data_ptr()))


@fused_cca_decode_f32.register_fake
def _fused_cca_decode_f32_fake(x1, x2a, x2b, rot1, rot2, consts, dims):
    del x2a, rot1, rot2, consts, dims
    windows = x1.shape[0]
    return x1.new_empty((windows,) if x2b is None else (2, windows),
                        dtype=torch.float32)
