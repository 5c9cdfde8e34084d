"""Jackknife x regularization grids from per-file moments (port of
sweep/engine.py).

The reference scales a lambda search by running one OS process per
(lambda, held-out file) and re-reading the data in each. This engine
replaces that with one program (telluride_decoding_tpu/sweep/engine.py:
1-23):

  * one pass over the data computes each file's MomentStats on the
    device;
  * leave-one-out training statistics are the total minus the file's;
  * the whole (lambda x held-out file) grid is solved and scored from
    moments alone: the held-out Pearson r of a linear or CCA prediction
    is a quadratic form of the solution with the file's moments, so raw
    frames never enter the grid.

The solves are batched ``torch.linalg`` calls over the file axis, and
over a chunk of lambdas x files where the JAX package chunks. Every
product runs in full float32 (TF32 off, ``device.full_fp32``), as the
JAX package's Precision.HIGHEST. With a ``ContextSpec`` only raw
channels reach the device and each file is lag-stacked there by kernel
K2 (``device_file_moments``), one launch per file per lagged input, so
lags never cross file boundaries.

``torch.linalg.cholesky`` raises where ``jnp.linalg.cholesky`` returns
NaNs. The programs factor with ``cholesky_ex`` and turn a failed factor
into NaNs, with no exception and no host sync inside the grid, so
``_finalize_sweep`` reaches the eig program exactly where the JAX
package does.

``multi_subject_sweep`` runs a whole cohort, subject after subject, in
the JAX package's depth-2 pipeline.

With a ``mesh`` (parallel.mesh.Mesh over a torch.distributed group; every
rank calls with the same arguments) the work spreads over the ranks as
the JAX package's mesh paths spread it over devices:

  * file-sharded (``ridge_jackknife_sweep``/``cca_jackknife_sweep`` with
    ``mesh``, and ``multi_subject_sweep`` without ``subject_parallel``):
    the file axis, padded to a multiple of the world size, splits into
    contiguous blocks; each rank takes its block's moments (K2 inside
    ``device_file_moments`` under a ``ContextSpec``), one all_reduce
    makes the total, each rank solves its block's columns of the grid
    and one gather returns the whole [L, F] grid to every rank. Given
    ``num_files``, a rank's lists hold only its block (``file_block``),
    so each rank reads only its own files;
  * subject-sharded (``multi_subject_sweep(mesh, subject_parallel=True)``):
    subject j goes to rank j mod W, which sweeps its subjects through the
    depth-2 pipeline (with the per-subject eig retry), and one gather of
    the padded grids returns every subject's grid to every rank. A rank
    may be given only its own subjects (``cohort_names``), so that it
    reads no other's. Subjects share nothing, so the gathers of the
    pads and the grids are the only communication.

``default_mesh`` gives a mesh only under an initialized group of more
than one rank, so one process keeps the serial paths bit for bit.
"""

from __future__ import annotations

import itertools
import logging
import os
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist

from telluride_decoding_torch import device as device_policy
from telluride_decoding_torch.data.brain_data import device_file_moments
from telluride_decoding_torch.ops.covariance import (MomentStats,
                                                     blocked_moments,
                                                     zeros_moments)
from telluride_decoding_torch.ops.lagstack import lag_stack
from telluride_decoding_torch.parallel import mesh as mesh_lib
from telluride_decoding_torch.solvers.cca import cca_covariances_from_stats
from telluride_decoding_torch.solvers.ridge import (_augmented_moments,
                                                    solve_ridge_from_moments)
from telluride_decoding_torch.utils import profiling

# The eig program amortizes one eigendecomposition per file over the
# grid from this many lambdas on (the JAX package's crossover, measured
# on a TPU v5e; engine.py:622-632).
EIG_MIN_LAMBDAS = 24
# Each sweep's index, the ``request`` of its spans.
_SWEEPS = itertools.count()


def _ensure_2d(a):
    """[N] -> [N, 1], keeping host or device residency."""
    if getattr(a, 'ndim', 2) != 1:
        return a
    return a[:, None] if isinstance(a, torch.Tensor) else \
        np.asarray(a)[:, None]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _to_device(a, device) -> torch.Tensor:
    """``a`` on ``device``; from host memory to the card, a blocking
    copy."""
    if not (isinstance(a, torch.Tensor) and a.is_cuda):
        profiling.host_wait(device)
    return device_policy.as_tensor(a, device, torch.float32)


class ContextSpec(NamedTuple):
    """Lag-window context applied on the device inside the moments pass.

    With a context spec, the sweeps take raw (un-stacked) per-file
    streams: x with exactly ``n_i + x_post`` rows and y with
    ``n_i + y_post`` rows, where ``n_i`` is the file's common
    (zip-truncated) frame count, zero-padded up where the source stream
    ends at ``n_i``. The moments equal those of a host ``lag_stack_np``
    followed by truncation to ``n_i``. cli.regression's
    ``Regression._per_file_raw`` produces this layout.
    """

    x_pre: int = 0
    x_post: int = 0
    y_pre: int = 0
    y_post: int = 0

    def stacked_widths(self, dx_raw: int, dy_raw: int
                       ) -> Tuple[int, int]:
        return (dx_raw * (self.x_pre + 1 + self.x_post),
                dy_raw * (self.y_pre + 1 + self.y_post))


class SweepResult(NamedTuple):
    correlations: np.ndarray   # [num_lambdas, num_files]
    lambdas: np.ndarray        # [num_lambdas]
    test_files: List[str]      # file per column


def _stage(timer, name: str, device: torch.device, request: int):
    """The span ``sweep.<name>``; with a timer, ``timer.stage(name)``
    with the device synchronised at its end as well."""
    if timer is None:
        return profiling.span('sweep.' + name, request)

    def sync():
        profiling.host_wait(device)
        torch.cuda.synchronize()
    return timer.stage(name, sync=sync if device.type == 'cuda' else None,
                       span_name='sweep.' + name, request=request)


def _stack_stats(stats_list: Sequence[MomentStats]) -> MomentStats:
    return MomentStats(*(torch.stack(leaves) for leaves in zip(*stats_list)))


def pad_and_stack(arrays: Sequence, pad_frames_to: Optional[int] = None,
                  pad_files_to: Optional[int] = None, device='cuda'
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacks variable-length [N_i, D] arrays into [F, N_max, D] + mask.

    Host arrays build the batch in one host buffer and cross to the
    device in one copy; tensors are padded on the device.
    ``pad_frames_to`` forces a larger N_max and ``pad_files_to`` a larger
    F (all-zero masks: exact zero statistics).
    """
    device = device_policy.resolve(device)
    arrays = [_ensure_2d(a) for a in arrays]
    max_n = max(max(a.shape[0] for a in arrays), pad_frames_to or 0)
    num_f = max(len(arrays), pad_files_to or 0)
    width = arrays[0].shape[1]
    with profiling.span('sweep.upload'):
        mask = np.zeros((num_f, max_n), np.float32)
        for i, a in enumerate(arrays):
            mask[i, :a.shape[0]] = 1.0
        if all(isinstance(a, torch.Tensor) for a in arrays):
            stacked = torch.zeros((num_f, max_n, width),
                                  dtype=torch.float32, device=device)
            for i, a in enumerate(arrays):
                stacked[i, :a.shape[0]] = _to_device(a, device)
        else:
            host = np.zeros((num_f, max_n, width), np.float32)
            for i, a in enumerate(arrays):
                host[i, :a.shape[0]] = _host(a)
            stacked = _to_device(host, device)
        return stacked, _to_device(mask, device)


def _batched_moments(x: torch.Tensor, y: torch.Tensor, want_syy: bool,
                     count: torch.Tensor) -> MomentStats:
    """MomentStats of each file of a [F, N, D] stack: one batched
    product per moment."""
    xt = x.transpose(1, 2)
    if want_syy:
        syy = y.transpose(1, 2) @ y
    else:
        syy = torch.zeros((y.shape[0], y.shape[2], y.shape[2]),
                          dtype=torch.float32, device=y.device)
    return MomentStats(count=count, sum_x=x.sum(1), sum_y=y.sum(1),
                       sxx=xt @ x, syy=syy, sxy=xt @ y)


def _uniform_file_moments(xs, ys, want_syy: bool, device) -> MomentStats:
    """Per-file MomentStats for files that all share one length: the raw
    [F, N, D] stack, no padding or masks, count N."""
    with profiling.span('sweep.upload'):
        if all(isinstance(a, torch.Tensor) for a in list(xs) + list(ys)):
            x = torch.stack([_to_device(a, device) for a in xs])
            y = torch.stack([_to_device(a, device) for a in ys])
        else:
            x = _to_device(np.stack([_host(a) for a in xs]), device)
            y = _to_device(np.stack([_host(a) for a in ys]), device)
    count = torch.full((x.shape[0],), float(x.shape[1]),
                       dtype=torch.float32, device=device)
    return _batched_moments(x, y, want_syy, count)


def _stacked_moments_ctx(xs: torch.Tensor, ys: torch.Tensor,
                         n_valid: Sequence[int], want_syy: bool,
                         ctx: ContextSpec) -> MomentStats:
    """Per-file MomentStats with the lag expansion on the device.

    xs: [F, R, dx] and ys: [F, R, dy] raw frames (zero rows beyond each
    file's data, R at least n_i + post for both); n_valid: the files'
    true frame counts. Each file is lag-stacked by kernel K2 (on CUDA)
    and its rows >= n_i are masked out of every sum
    (``device_file_moments``); the stacked matrix exists one file at a
    time, on the device only.
    """
    return _stack_stats([
        device_file_moments(x, y, int(n), pre=ctx.x_pre, post=ctx.x_post,
                            pre_y=ctx.y_pre, post_y=ctx.y_post,
                            want_syy=want_syy)
        for x, y, n in zip(xs, ys, n_valid)])


def _stacked_moments(xs: torch.Tensor, ys: torch.Tensor,
                     masks: torch.Tensor, want_syy: bool) -> MomentStats:
    """Per-file MomentStats from a padded [F, N, D] stack and its
    [F, N] validity masks."""
    m = masks[:, :, None]
    return _batched_moments(xs * m, ys * m, want_syy, masks.sum(1))


def _pad_stats_files(stats: MomentStats, pad_files_to: Optional[int],
                     num_real: int) -> MomentStats:
    """Appends zero-statistics dummy files up to pad_files_to (exact:
    they contribute nothing to leave-one-out totals)."""
    if pad_files_to and pad_files_to > num_real:
        pad = pad_files_to - num_real
        stats = MomentStats(*(
            torch.cat([a, torch.zeros((pad,) + tuple(a.shape[1:]),
                                      dtype=a.dtype, device=a.device)])
            for a in stats))
    return stats


def _device_stack_one(raw, pre: int, post: int, rows: int, device
                      ) -> torch.Tensor:
    """Lag expansion of ONE file's raw stream on ``device``
    (bounded-memory regime), as a [rows, ...] buffer: the raw rows go up
    zero-padded behind and kernel K2 stacks them on a card (its plain
    version on the CPU) straight into the buffer the moments read. Rows
    below the file's n_i equal lag_stack_np's; the moments mask the rest.
    """
    with profiling.span('sweep.upload'):
        raw = _to_device(raw, device)
    padded = torch.zeros((max(rows, raw.shape[0]), raw.shape[1]),
                         dtype=torch.float32, device=device)
    padded[:raw.shape[0]] = raw
    return lag_stack(padded, pre, post)[:rows]


def _batch_bytes_from_env() -> int:
    try:
        return int(float(os.environ.get('TDT_SWEEP_MOMENTS_BYTES',
                                        2 << 30)))
    except ValueError:
        return 2 << 30


def per_file_stats(per_file_x: Sequence, per_file_y: Sequence,
                   want_syy: bool, pad_files_to: Optional[int] = None,
                   pad_frames_to: Optional[int] = None,
                   frame_bucket: int = 4096,
                   batch_bytes: Optional[int] = None,
                   context: Optional[ContextSpec] = None,
                   device='cuda') -> MomentStats:
    """Stacked [F, ...] MomentStats on ``device``; raw frames stay
    transient.

    Two regimes, value-identical:

      * batched (whenever the padded [F, N_max, D] stack fits
        ``batch_bytes``, env TDT_SWEEP_MOMENTS_BYTES, default 2 GiB):
        one upload of the stack and one batched product per moment;
      * streaming (larger corpora): one file at a time, its frames
        padded to a ``frame_bucket`` multiple with a validity mask, so
        peak memory is one padded file.

    Dummy files up to ``pad_files_to`` contribute exact-zero statistics
    (count 0), preserving leave-one-out totals.

    With ``context`` (a ContextSpec with any nonzero lag), the inputs
    are raw streams in the ContextSpec layout. The batched regime
    uploads the raw channels once and lag-stacks each file on the device
    (K2); ``pad_frames_to`` then refers to the common (zip-truncated)
    frame axis. The streaming regime uploads and stacks one file at a
    time (K2 too).
    """
    device = device_policy.resolve(device)
    if batch_bytes is None:
        batch_bytes = _batch_bytes_from_env()
    per_file_x = [_ensure_2d(x) for x in per_file_x]
    per_file_y = [_ensure_2d(y) for y in per_file_y]
    if len(per_file_x) != len(per_file_y):
        raise ValueError('per_file_stats got %d x files but %d y '
                         'files.' % (len(per_file_x), len(per_file_y)))
    if context is None or not any(context):
        for i, (x, y) in enumerate(zip(per_file_x, per_file_y)):
            if x.shape[0] != y.shape[0]:
                raise ValueError(
                    'per_file_stats: file %d has %d x frames but %d '
                    'y frames; per-file x and y must align.'
                    % (i, x.shape[0], y.shape[0]))
    num_real = len(per_file_x)
    # The staged stack scales with the PADDED file count.
    num_f_est = max(num_real, pad_files_to or 0)

    ctx = context if context is not None and any(context) else None
    if ctx is not None:
        n_list = [x.shape[0] - ctx.x_post for x in per_file_x]
        for i, (y, n) in enumerate(zip(per_file_y, n_list)):
            if y.shape[0] - ctx.y_post != n:
                raise ValueError(
                    'context layout violated for file %d: raw x has '
                    '%d rows (n=%d with x_post=%d) but raw y has %d '
                    'rows, expected n + y_post = %d'
                    % (i, per_file_x[i].shape[0], n, ctx.x_post,
                       y.shape[0], n + ctx.y_post))
        x_w, y_w = ctx.stacked_widths(per_file_x[0].shape[1],
                                      per_file_y[0].shape[1])
        n_common = max(max(n_list), pad_frames_to or 0)
        # The budget is the stacked transient the JAX package's fused
        # program holds; here one file's stack lives at a time, but the
        # regime follows the same rule so both packages pick alike.
        if num_f_est * n_common * (x_w + y_w) * 4 <= batch_bytes:
            rows = n_common + max(ctx.x_post, ctx.y_post)
            xs, _ = pad_and_stack(per_file_x, rows, device=device)
            ys, _ = pad_and_stack(per_file_y, rows, device=device)
            stats = _stacked_moments_ctx(xs, ys, n_list, want_syy, ctx)
            del xs, ys
            return _pad_stats_files(stats, pad_files_to, num_real)
        # Bounded-memory regime: the streaming loop below stacks each
        # file on the device right before its moments.
    max_n = max(max(x.shape[0] for x in per_file_x), pad_frames_to or 0)
    width = per_file_x[0].shape[1] + per_file_y[0].shape[1]
    est = num_f_est * max_n * width * 4

    if est <= batch_bytes and ctx is None:
        x_lens = {x.shape[0] for x in per_file_x}
        y_lens = {y.shape[0] for y in per_file_y}
        pads_match = ((pad_files_to is None or pad_files_to == num_real)
                      and (pad_frames_to is None
                           or x_lens == {pad_frames_to}))
        if len(x_lens) == 1 and x_lens == y_lens and pads_match:
            stats = _uniform_file_moments(per_file_x, per_file_y,
                                          want_syy, device)
        else:
            xs, masks = pad_and_stack(per_file_x, pad_frames_to,
                                      pad_files_to, device)
            ys, _ = pad_and_stack(per_file_y, pad_frames_to,
                                  pad_files_to, device)
            stats = _stacked_moments(xs, ys, masks, want_syy)
            del xs, ys, masks   # Transient: freed before the grid.
        return _pad_stats_files(stats, pad_files_to,
                                int(stats.count.shape[0]))

    stats_list = []
    for x, y in zip(per_file_x, per_file_y):
        n = x.shape[0] - (ctx.x_post if ctx is not None else 0)
        padded = -(-n // frame_bucket) * frame_bucket
        if ctx is not None:
            xp = _device_stack_one(x, ctx.x_pre, ctx.x_post, padded, device)
            yp = _device_stack_one(y, ctx.y_pre, ctx.y_post, padded, device)
        else:
            xp = torch.zeros((padded, x.shape[1]), dtype=torch.float32,
                             device=device)
            yp = torch.zeros((padded, y.shape[1]), dtype=torch.float32,
                             device=device)
            with profiling.span('sweep.upload'):
                xp[:n] = _to_device(x, device)
                yp[:y.shape[0]] = _to_device(y, device)
        valid = (torch.arange(padded, device=device) < n).float()
        stats_list.append(blocked_moments(xp, yp, want_syy=want_syy,
                                          valid=valid, block=frame_bucket))
    if pad_files_to:
        dx = stats_list[0].sum_x.shape[0]
        dy = stats_list[0].sum_y.shape[0]
        stats_list += [zeros_moments(dx, dy, device)] * (
            pad_files_to - len(stats_list))
    return _stack_stats(stats_list)


def _tree_index(stats: MomentStats, index) -> MomentStats:
    return MomentStats(*(a[index] for a in stats))


def _lam_chunk_units(num_files: int, dim_sq_elems: int,
                     num_l: int) -> int:
    """How many lambdas' factorizations to batch per dispatch.

    Each lambda's transient is about two buffers (shifted covariance and
    its Cholesky factor) of num_files x dim^2 floats. The 7 GiB default
    budget is the JAX package's (chunk 3 at codelab scale, measured on a
    TPU v5e; engine.py:431-443), kept here for parity and not retuned
    for the card. Overrides: TDT_SWEEP_LAM_CHUNK (explicit count),
    TDT_SWEEP_LAM_CHUNK_BYTES (budget).
    """
    explicit = os.environ.get('TDT_SWEEP_LAM_CHUNK')
    if explicit:
        try:
            return max(1, min(num_l, int(float(explicit))))
        except (ValueError, OverflowError):
            logging.warning(
                'Unparseable TDT_SWEEP_LAM_CHUNK=%r; falling back to '
                'the byte-budget heuristic.', explicit)
    try:
        budget = int(float(os.environ.get('TDT_SWEEP_LAM_CHUNK_BYTES',
                                          7 << 30)))
    except (ValueError, OverflowError):
        budget = 7 << 30
    unit = 2 * num_files * dim_sq_elems * 4
    return max(1, min(num_l, budget // max(unit, 1)))


def _chunked_lam_map(eval_chunk: Callable[[torch.Tensor], torch.Tensor],
                     lambdas: torch.Tensor, chunk: int) -> torch.Tensor:
    """[L, F] grid from ``eval_chunk(lambdas[i:i + chunk]) -> [c, F]``.

    Each call evaluates ``chunk`` lambdas x all files as one batch of
    factorizations. The JAX package pads the last chunk with lambda = 1
    to keep one program shape; here the last chunk is just shorter,
    which computes the same cells.
    """
    def timed(lams):
        with profiling.span('sweep.lam_chunk'):
            return eval_chunk(lams)
    return torch.cat([timed(lambdas[start:start + chunk])
                      for start in range(0, lambdas.shape[0], chunk)])


def _linear_r_from_stats(stats: MomentStats, w: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """Pearson r (first output column) of pred = x @ w + b on the file
    summarized by ``stats``; no raw frames needed.

    Leading batch dimensions of w [..., Dx, Dy] and b [..., Dy] match
    those of stats. Requires stats built with want_syy=True (uses
    syy[0, 0]). A zero-count dummy file comes out 0.

    Numerical boundary (as in the JAX package, engine.py:493-500; it
    applies to _cca_r_from_stats too): variances come from uncentered
    float32 second moments, so a DC offset mu much larger than the
    standard deviation sigma cancels about (mu/sigma)^2 digits; accuracy
    degrades past mu/sigma ~ 100. The ingest z-scores, so production
    data is near zero-mean.
    """
    w0 = w[..., 0]
    b0 = b[..., 0]
    count = stats.count
    n = torch.clamp(count, min=1.0)
    sum_xw = (stats.sum_x * w0).sum(-1)
    sum_p = sum_xw + count * b0
    sxx_w = (stats.sxx @ w0[..., None])[..., 0]
    sum_pp = (w0 * sxx_w).sum(-1) + 2.0 * b0 * sum_xw + count * b0 * b0
    sum_y0 = stats.sum_y[..., 0]
    sum_yy = stats.syy[..., 0, 0]
    sum_yp = (stats.sxy[..., :, 0] * w0).sum(-1) + b0 * sum_y0
    cov = sum_yp - sum_y0 * sum_p / n
    var_p = sum_pp - sum_p * sum_p / n
    var_y = sum_yy - sum_y0 * sum_y0 / n
    power = torch.sqrt(torch.clamp(var_p, min=0.0) *
                       torch.clamp(var_y, min=0.0))
    return cov / torch.where(power <= 0, torch.ones_like(power), power)


def _cca_r_from_stats(stats: MomentStats, u: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Pearson r of (x @ u) vs (y @ v) on the file summarized by
    ``stats`` (want_syy=True); u [..., Dx] and v [..., Dy] carry the
    stats' leading batch dimensions. Pearson is shift-invariant, so the
    train-mean centering of the dense evaluator drops out."""
    def quad(m, a, b):
        return (a * (m @ b[..., None])[..., 0]).sum(-1)
    n = torch.clamp(stats.count, min=1.0)
    sum_a = (stats.sum_x * u).sum(-1)
    sum_b = (stats.sum_y * v).sum(-1)
    saa = quad(stats.sxx, u, u)
    sbb = quad(stats.syy, v, v)
    sab = quad(stats.sxy, u, v)
    cov = sab - sum_a * sum_b / n
    var_a = saa - sum_a * sum_a / n
    var_b = sbb - sum_b * sum_b / n
    power = torch.sqrt(torch.clamp(var_a, min=0.0) *
                       torch.clamp(var_b, min=0.0))
    return cov / torch.where(power <= 0, torch.ones_like(power), power)


def _total_minus(stacked: MomentStats, total: MomentStats,
                 index) -> MomentStats:
    """Training statistics without file ``index`` (a slice gives all
    files' at once)."""
    return MomentStats(*(tot - per[index]
                         for tot, per in zip(total, stacked)))


def _symmetrize(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + a.transpose(-1, -2))


def _cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a batch; a factor that fails (not
    positive definite) becomes all NaN, as ``jnp.linalg.cholesky``
    returns. No exception, no host sync."""
    factor, info = torch.linalg.cholesky_ex(a)
    return factor.masked_fill_((info != 0)[..., None, None], float('nan'))


def _svd_uv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Thin SVD's u and vt of a batch. A matrix with non-finite entries
    (from a failed factor upstream) is decomposed as zeros instead,
    since ``torch.linalg.svd`` raises on it; its NaNs still reach the
    result through the factor."""
    finite = torch.isfinite(t).all(-1).all(-1)
    t = torch.where(finite[..., None, None], t, torch.zeros_like(t))
    # Reads back to the host twice on the card (torch 2.11, as
    # torch.cuda.set_sync_debug_mode reports).
    profiling.host_wait(t.device, 2)
    u, _, vt = torch.linalg.svd(t, full_matrices=False)
    return u, vt


def _ridge_sweep_program(stacked: MomentStats, total: MomentStats,
                         lambdas: torch.Tensor, use_ridge: bool = True,
                         force_eig: bool = False) -> torch.Tensor:
    """[L, F] held-out correlations from per-file MomentStats alone.

    Three paths, as the JAX package's (engine.py:552-667):
      * ridge, fewer than EIG_MIN_LAMBDAS lambdas: each file's
        lambda-independent augmented covariance is built once ([F, D, D])
        and each chunk of lambdas x files is one batched Cholesky
        factorization and solve;
      * ridge, EIG_MIN_LAMBDAS or more lambdas or ``force_eig``: one
        eigendecomposition per file serves every lambda; degenerate
        directions (lambda = 0 on a rank-deficient covariance) drop out,
        the pseudoinverse answer;
      * shrinkage (``use_ridge=False``): solve_ridge_from_moments per
        cell.
    """
    num_files = stacked.count.shape[0]
    num_l = lambdas.shape[0]
    if use_ridge and not force_eig and num_l < EIG_MIN_LAMBDAS:
        train = _total_minus(stacked, total, slice(None))
        szz, szy = _augmented_moments(train)
        n = train.count[:, None, None]
        cov_all = _symmetrize(szz / n)
        rhs_all = szy / n
        del train, szz, szy
        eye = torch.eye(cov_all.shape[-1], dtype=cov_all.dtype,
                        device=cov_all.device)

        def eval_chol(lams):
            factor = _cholesky_or_nan(cov_all + lams[:, None, None, None]
                                      * eye)
            solution = torch.cholesky_solve(rhs_all, factor)
            del factor
            return torch.stack([
                _linear_r_from_stats(stacked, s[..., :-1, :], s[..., -1, :])
                for s in solution])

        chunk = _lam_chunk_units(num_files, cov_all.shape[-1] ** 2, num_l)
        return _chunked_lam_map(eval_chol, lambdas, chunk)

    if use_ridge:
        train = _total_minus(stacked, total, slice(None))
        szz, szy = _augmented_moments(train)
        n = train.count[:, None, None]
        e, v = torch.linalg.eigh(_symmetrize(szz / n))
        vt_cov_xy = v.transpose(-1, -2) @ (szy / n)
        del train, szz, szy
        rows = []
        for lamb in lambdas:
            shifted = e + lamb
            inv = torch.where(shifted > 1e-12,
                              1.0 / torch.clamp(shifted, min=1e-12),
                              torch.zeros_like(shifted))
            solution = v @ (vt_cov_xy * inv[..., None])
            rows.append(_linear_r_from_stats(stacked, solution[..., :-1, :],
                                             solution[..., -1, :]))
        return torch.stack(rows)

    rows = []
    for lamb in lambdas:
        row = []
        for f in range(num_files):
            sol = solve_ridge_from_moments(
                _total_minus(stacked, total, f), lamb, use_ridge=False)
            row.append(_linear_r_from_stats(_tree_index(stacked, f),
                                            sol.w, sol.b))
        rows.append(torch.stack(row))
    return torch.stack(rows)


def _ridge_eig_program(stacked: MomentStats, total: MomentStats,
                       lambdas: torch.Tensor) -> torch.Tensor:
    return _ridge_sweep_program(stacked, total, lambdas, force_eig=True)


def _cca_covariances(stacked: MomentStats, total: MomentStats):
    """Each file's leave-one-out cov_xx, cov_yy (symmetrized) and cov_xy,
    [F, ...]. Means are not kept: _cca_r_from_stats is shift-invariant."""
    _, _, cov_xx, cov_yy, cov_xy = cca_covariances_from_stats(
        _total_minus(stacked, total, slice(None)))
    return _symmetrize(cov_xx), _symmetrize(cov_yy), cov_xy


def _cca_sweep_program_chol(stacked: MomentStats, total: MomentStats,
                            lambdas: torch.Tensor) -> torch.Tensor:
    """CCA grid with Cholesky whitening, the default path.

    Canonical correlations are invariant to the whitening (any W with
    W cov W^T = I); with W = L^-1 from cov + lamb I = L L^T each cell is
    one Cholesky factorization, triangular solves and one SVD, scored by
    the first canonical pair. lamb = 0 on a rank-deficient covariance
    gives NaNs, and the caller reruns the eig program.
    """
    cov_xx, cov_yy, cov_xy = _cca_covariances(stacked, total)
    dx, dy = cov_xx.shape[-1], cov_yy.shape[-1]
    eye_x = torch.eye(dx, dtype=cov_xx.dtype, device=cov_xx.device)
    eye_y = torch.eye(dy, dtype=cov_yy.dtype, device=cov_yy.device)

    def eval_chunk(lams):
        lam = lams[:, None, None, None]
        l1 = _cholesky_or_nan(cov_xx + lam * eye_x)
        l2 = _cholesky_or_nan(cov_yy + lam * eye_y)
        t = torch.linalg.solve_triangular(l1, cov_xy, upper=False)
        t = torch.linalg.solve_triangular(
            l2, t.transpose(-1, -2), upper=False).transpose(-1, -2)
        u, vt = _svd_uv(t)
        rot_x = torch.linalg.solve_triangular(l1.transpose(-1, -2),
                                              u[..., :1], upper=True)
        del l1
        rot_y = torch.linalg.solve_triangular(
            l2.transpose(-1, -2), vt.transpose(-1, -2)[..., :1],
            upper=True)
        return torch.stack([
            _cca_r_from_stats(stacked, rx[..., 0], ry[..., 0])
            for rx, ry in zip(rot_x, rot_y)])

    chunk = _lam_chunk_units(stacked.count.shape[0], dx * dx + dy * dy,
                             lambdas.shape[0])
    return _chunked_lam_map(eval_chunk, lambdas, chunk)


def _cca_sweep_program(stacked: MomentStats, total: MomentStats,
                       lambdas: torch.Tensor) -> torch.Tensor:
    """CCA grid with one eigendecomposition per file reused across the
    lambda axis: (cov + lamb I) shares cov's eigenvectors. The fallback
    for grids the Cholesky program cannot factor; degenerate directions
    are zeroed out of the whitening, not clamped (which would amplify
    them), as in solve_cca_from_moments."""
    cov_xx, cov_yy, cov_xy = _cca_covariances(stacked, total)
    ex, vx = torch.linalg.eigh(cov_xx)
    ey, vy = torch.linalg.eigh(cov_yy)
    del cov_xx, cov_yy

    def whitener(e, v, lamb):
        shifted = e + lamb
        inv = torch.where(shifted > 1e-12,
                          torch.rsqrt(torch.clamp(shifted, min=1e-12)),
                          torch.zeros_like(shifted))
        return (v * inv[..., None, :]) @ v.transpose(-1, -2)

    rows = []
    for lamb in lambdas:
        k11 = whitener(ex, vx, lamb)
        k22 = whitener(ey, vy, lamb)
        u, vt = _svd_uv(k11 @ cov_xy @ k22)
        rot_x = k11 @ u[..., :1]
        rot_y = k22 @ vt.transpose(-1, -2)[..., :1]
        rows.append(_cca_r_from_stats(stacked, rot_x[..., 0],
                                      rot_y[..., 0]))
    return torch.stack(rows)


def _mesh_file_padding(num_real: int, pad_files_to: Optional[int],
                       mesh: Optional[mesh_lib.Mesh]) -> Optional[int]:
    """File-axis padding target that splits evenly over the mesh.

    Rounds the requested (or natural) file count up to a multiple of the
    mesh size, so 22 files on 8 ranks pad to 24 and run 3 a rank.
    Padding files contribute exact-zero statistics and are sliced away
    from the result.
    """
    target = max(num_real, pad_files_to or 0)
    if mesh is not None:
        target = -(-target // mesh.size) * mesh.size
    return target if target > num_real else pad_files_to


def file_block(num_files: int, mesh: mesh_lib.Mesh,
               pad_files_to: Optional[int] = None) -> Tuple[int, int]:
    """[lo, hi): the real files in this rank's contiguous block of the
    file axis, padded to a multiple of the mesh size. The files a rank
    reads when it passes ``num_files`` to the sweeps; an empty range is
    a block of padding only."""
    padded = _mesh_file_padding(num_files, pad_files_to, mesh) or num_files
    per = padded // mesh.size
    lo = min(mesh.rank * per, num_files)
    return lo, min(lo + per, num_files)


def _file_sharded_stats(per_file_x, per_file_y, mesh: mesh_lib.Mesh,
                        num_files: int, pad_frames_to, context, device,
                        rank_local: bool = False) -> MomentStats:
    """[num_files / size, ...] MomentStats of this rank's block of the
    padded file axis (``num_files`` long); a block of padding only is all
    zeros. ``rank_local``: per_file_x/y hold only the block's real files
    (file_block), else every file."""
    per = num_files // mesh.size
    if rank_local:
        xs, ys = per_file_x, per_file_y
        # A block of padding only has no file to take widths from: one
        # gather of the raw widths, which every rank joins.
        widths = torch.tensor(
            [_ensure_2d(xs[0]).shape[1], _ensure_2d(ys[0]).shape[1]]
            if xs else [0, 0], dtype=torch.int64)
        dx, dy = (int(w) for w in mesh_lib.gather(widths, mesh).amax(0))
    else:
        lo, hi = file_block(len(per_file_x), mesh, num_files)
        xs, ys = per_file_x[lo:hi], per_file_y[lo:hi]
        dx = _ensure_2d(per_file_x[0]).shape[1]
        dy = _ensure_2d(per_file_y[0]).shape[1]
    if xs:
        return per_file_stats(xs, ys, want_syy=True, pad_files_to=per,
                              pad_frames_to=pad_frames_to, context=context,
                              device=device)
    if context is not None and any(context):
        dx, dy = context.stacked_widths(dx, dy)
    return MomentStats(*(z.expand((per,) + tuple(z.shape)).clone()
                         for z in zeros_moments(dx, dy, device)))


def _gathered_grid(corr: torch.Tensor,
                   mesh: Optional[mesh_lib.Mesh]) -> np.ndarray:
    """The whole [L, F] grid on the host: every rank's [L, F / size]
    block side by side (one all_gather), or ``corr`` itself."""
    profiling.host_wait(corr.device)
    if mesh is None:
        return corr.cpu().numpy()
    blocks = mesh_lib.gather(corr, mesh)
    return blocks.permute(1, 0, 2).reshape(corr.shape[0], -1).cpu().numpy()


class _InFlightSweep(NamedTuple):
    """A dispatched grid not yet read back. ``stacked`` and ``total``
    are kept so the NaN fallback can rerun the eig program without
    recomputing moments. Under a mesh, ``corr`` and ``stacked`` hold this
    rank's block of files and ``total`` the sum over every file."""

    corr: torch.Tensor         # [L, F_padded] correlations, on the device.
    stacked: MomentStats
    total: MomentStats
    lambdas: np.ndarray
    lambdas_arr: torch.Tensor
    num_real: int
    file_names: Optional[List[str]]
    model: str                 # 'ridge' | 'cca'
    use_ridge: bool
    mesh: Optional[mesh_lib.Mesh]
    request: int = -1          # The sweep's index (its spans' request).


def _dispatch_sweep(model: str, per_file_x, per_file_y, lambdas,
                    file_names=None, use_ridge=True, pad_files_to=None,
                    pad_frames_to=None, context=None, device='cuda',
                    timer=None, before_grid: Optional[Callable[[], None]]
                    = None, mesh: Optional[mesh_lib.Mesh] = None,
                    num_files: Optional[int] = None) -> _InFlightSweep:
    """Moments and the grid for one file set, not yet read back.
    ``before_grid`` runs between the two (the cohort pipeline finalizes
    the previous subject there, so its buffers are freed before this
    grid allocates). With ``mesh``, this rank's block of files (see the
    module docstring); with ``num_files`` as well, per_file_x/y hold
    only that block's files (file_block), so no rank reads another's."""
    device = device_policy.resolve(device)
    rank_local = mesh is not None and num_files is not None
    num_real = num_files if rank_local else len(per_file_x)
    if rank_local:
        lo, hi = file_block(num_real, mesh, pad_files_to)
        if len(per_file_x) != hi - lo:
            raise ValueError('rank %d of %d got %d files, not its block '
                             '[%d, %d) of %d' % (mesh.rank, mesh.size,
                                                 len(per_file_x), lo, hi,
                                                 num_real))
    pad_files_to = _mesh_file_padding(num_real, pad_files_to, mesh)
    per_file_y = [_ensure_2d(y) for y in per_file_y]
    if (model != 'cca' and not use_ridge
            and any(float(l) < 0 for l in np.asarray(lambdas).ravel())):
        # The moments carry no sum(x^2.T @ x^2), so the Ledoit-Wolf
        # auto sentinel (-1) cannot be honored; solve_ridge_from_moments
        # would clip it to shrinkage 0 under a row labeled -1.
        raise ValueError(
            'shrinkage sweep (use_ridge=False) cannot honor the -1 '
            'auto-shrinkage sentinel: the moments-only programs lack '
            'the Ledoit-Wolf sum(x2.T x2) statistic. Use the dense '
            'path (solvers.ridge.calculate_linear_regressor_'
            'parameters) for lamb=-1, or pass explicit shrinkage '
            'values in [0, 1].')
    request = next(_SWEEPS)
    lambdas_arr = _to_device(np.asarray(lambdas, np.float32), device)
    with _stage(timer, 'moments', device, request):
        if mesh is None:
            stacked = per_file_stats(per_file_x, per_file_y, want_syy=True,
                                     pad_files_to=pad_files_to,
                                     pad_frames_to=pad_frames_to,
                                     context=context, device=device)
            total = MomentStats(*(s.sum(0) for s in stacked))
        else:
            stacked = _file_sharded_stats(
                per_file_x, per_file_y, mesh, pad_files_to or num_real,
                pad_frames_to, context, device, rank_local)
            total = mesh_lib.all_reduce_stats(
                MomentStats(*(s.sum(0) for s in stacked)), mesh)
    if before_grid is not None:
        before_grid()
    with _stage(timer, 'grid', device, request):
        if model == 'cca':
            corr = _cca_sweep_program_chol(stacked, total, lambdas_arr)
        else:
            corr = _ridge_sweep_program(stacked, total, lambdas_arr,
                                        use_ridge=use_ridge)
    return _InFlightSweep(corr, stacked, total, np.asarray(lambdas),
                          lambdas_arr, num_real, file_names, model,
                          use_ridge, mesh, request)


def _finalize_sweep(inflight: _InFlightSweep, timer=None) -> SweepResult:
    """Reads the grid back (gathered from every rank under a mesh);
    applies the NaN -> eig fallback, which every rank then takes alike."""
    num_real = inflight.num_real
    with profiling.span('sweep.readback', inflight.request):
        corr = _gathered_grid(inflight.corr, inflight.mesh)
    # Rank-deficient covariance with lamb == 0 breaks Cholesky: the eig
    # programs zero degenerate directions instead (the pseudoinverse
    # answer). Only ridge and CCA have an eig program; shrinkage keeps
    # its non-finite cells.
    retry = (_cca_sweep_program if inflight.model == 'cca' else
             _ridge_eig_program if inflight.use_ridge else None)
    if retry is not None and not np.isfinite(corr[:, :num_real]).all():
        with _stage(timer, 'eig_retry', inflight.corr.device,
                    inflight.request):
            corr = _gathered_grid(retry(inflight.stacked, inflight.total,
                                        inflight.lambdas_arr), inflight.mesh)
    return SweepResult(corr[:, :num_real], inflight.lambdas,
                       inflight.file_names or
                       ['file%d' % i for i in range(num_real)])


def ridge_jackknife_sweep(per_file_x: Sequence, per_file_y: Sequence,
                          lambdas: Sequence[float],
                          file_names: Optional[List[str]] = None,
                          use_ridge: bool = True,
                          pad_files_to: Optional[int] = None,
                          pad_frames_to: Optional[int] = None,
                          context: Optional[ContextSpec] = None,
                          device='cuda', timer=None,
                          mesh: Optional[mesh_lib.Mesh] = None,
                          num_files: Optional[int] = None
                          ) -> SweepResult:
    """Leave-one-file-out ridge sweep over a lambda grid.

    per_file_x[i]: lag-stacked input of file i ([N_i, Dx]), or raw
    [N_i + x_post, dx] streams with ``context`` (lag expansion on the
    device); per_file_y[i]: target ([N_i, Dy] or [N_i]). Returns
    correlations[num_lambdas, num_files], entry (l, f) the test
    correlation on file f of a model trained on all other files with
    regularization lambdas[l]. ``use_ridge=False`` sweeps shrinkage
    values in [0, 1] instead. ``timer`` (a profiling.StageTimer) gets
    the stages moments, grid and, if taken, eig_retry. ``mesh`` shards
    the file axis over its ranks (a collective call; every rank gets the
    whole grid). With ``mesh`` and ``num_files`` (the whole file count),
    each rank passes only the files of its block, ``file_block(num_files,
    mesh, pad_files_to)``, and ``file_names`` for all of them.
    """
    return _finalize_sweep(_dispatch_sweep(
        'ridge', per_file_x, per_file_y, lambdas, file_names=file_names,
        use_ridge=use_ridge, pad_files_to=pad_files_to,
        pad_frames_to=pad_frames_to, context=context, device=device,
        timer=timer, mesh=mesh, num_files=num_files), timer)


def cca_jackknife_sweep(per_file_x: Sequence, per_file_y: Sequence,
                        lambdas: Sequence[float], dims: int = 5,
                        file_names: Optional[List[str]] = None,
                        pad_files_to: Optional[int] = None,
                        pad_frames_to: Optional[int] = None,
                        context: Optional[ContextSpec] = None,
                        device='cuda', timer=None,
                        mesh: Optional[mesh_lib.Mesh] = None,
                        num_files: Optional[int] = None
                        ) -> SweepResult:
    """Leave-one-file-out CCA sweep: the correlation of the first
    canonical pair on the held-out file, over a regularization grid.

    ``dims`` is accepted for symmetry with the CCA model but does not
    affect the sweep: the metric is the first canonical pair, as the
    reference jackknife's cca_pearson_correlation_first. ``mesh`` and
    ``num_files`` shard the file axis, as in ridge_jackknife_sweep.
    """
    del dims
    return _finalize_sweep(_dispatch_sweep(
        'cca', per_file_x, per_file_y, lambdas, file_names=file_names,
        pad_files_to=pad_files_to, pad_frames_to=pad_frames_to,
        context=context, device=device, timer=timer, mesh=mesh,
        num_files=num_files), timer)


def _pipelined_sweep(items, lambdas, model: str, use_ridge: bool,
                     pad_files_to, pad_frames_to, context, device,
                     mesh: Optional[mesh_lib.Mesh]) -> Dict[str, SweepResult]:
    """The JAX package's depth-2 pipeline over (name, (xs, ys)) pairs:
    subject k+1's moments are dispatched, subject k is read back (and
    retried through the eig program if its Cholesky grid failed) and
    dropped, then subject k+1's grid runs."""
    results = {}
    pending: List[Tuple[str, _InFlightSweep]] = []

    def finalize_pending():
        while pending:
            name, inflight = pending.pop()
            results[name] = _finalize_sweep(inflight)

    for name, (xs, ys) in items:
        pending.append((name, _dispatch_sweep(
            'cca' if model == 'cca' else 'ridge', xs, ys, lambdas,
            use_ridge=use_ridge, pad_files_to=pad_files_to,
            pad_frames_to=pad_frames_to, context=context, device=device,
            before_grid=finalize_pending, mesh=mesh)))
    finalize_pending()
    return results


def _subject_parallel_sweep(items, lambdas, model: str,
                            mesh: mesh_lib.Mesh, use_ridge: bool,
                            pad_files_to, pad_frames_to, context, device,
                            cohort_names: Optional[Sequence[str]] = None
                            ) -> Dict[str, SweepResult]:
    """The cohort with its subject axis sharded over the mesh.

    Subject j of the cohort goes to rank j mod W (the JAX package's
    groups of ndev subjects, one a device). With ``cohort_names`` (the
    whole cohort's names, in order) ``items`` holds only this rank's
    subjects, cohort_names[rank::W], and no rank reads another's; without
    it ``items`` is the whole cohort and each rank skips the others'
    pairs (eager pairs cost nothing to skip; a lazy iterable reads them).
    Each rank sweeps its subjects through the depth-2 pipeline with the
    per-subject eig retry, so a rank-deficient subject reruns alone. Then
    one gather of the file counts and one of the grids, padded to
    [ceil(S / W), L, max files], give every rank every subject's grid,
    in the cohort's order.
    """
    names: List[str] = list(cohort_names or [])

    def mine():
        for j, (name, pair) in enumerate(items):
            if cohort_names is not None:
                yield name, pair
                continue
            names.append(name)
            if j % mesh.size == mesh.rank:
                yield name, pair

    local = _pipelined_sweep(mine(), lambdas, model, use_ridge,
                             pad_files_to, pad_frames_to, context, device,
                             None)
    mine_names = names[mesh.rank::mesh.size]
    if sorted(local) != sorted(mine_names):
        raise ValueError('rank %d of %d swept subjects %s, not its share %s '
                         'of the cohort' % (mesh.rank, mesh.size,
                                            sorted(local), mine_names))
    per_rank = -(-len(names) // mesh.size)
    counts = torch.zeros((per_rank,), dtype=torch.int64)
    for k, name in enumerate(mine_names):
        counts[k] = local[name].correlations.shape[1]
    counts = mesh_lib.gather(counts, mesh)
    grids = torch.zeros((per_rank, len(lambdas), int(counts.max())),
                        dtype=torch.float32)
    for k, name in enumerate(mine_names):
        corr = local[name].correlations
        grids[k, :, :corr.shape[1]] = torch.from_numpy(
            np.asarray(corr, np.float32))
    grids = mesh_lib.gather(grids, mesh).numpy()
    results = {}
    for j, name in enumerate(names):
        rank, k = j % mesh.size, j // mesh.size
        num_files = int(counts[rank, k])
        results[name] = SweepResult(
            grids[rank, k, :, :num_files], np.asarray(lambdas),
            ['file%d' % f for f in range(num_files)])
    return results


def multi_subject_sweep(subjects, lambdas: Sequence[float],
                        model: str = 'ridge', dims: int = 5,
                        use_ridge: bool = True,
                        shared_shapes: bool = True,
                        subject_parallel: bool = False,
                        context: Optional[ContextSpec] = None,
                        pad_files_to: Optional[int] = None,
                        pad_frames_to: Optional[int] = None,
                        device='cuda',
                        mesh: Optional[mesh_lib.Mesh] = None,
                        cohort_names: Optional[Sequence[str]] = None
                        ) -> Dict[str, SweepResult]:
    """Per-subject jackknife x lambda grids for a whole cohort (JAX
    engine.py:1128-1235).

    ``subjects`` maps subject name -> (per_file_x, per_file_y): a dict
    or list of (name, (xs, ys)) pairs (eager), or any other iterable of
    such pairs, consumed one subject at a time (streaming: a prefetching
    loader keeps about two subjects on the host). Files never mix across
    subjects. With ``shared_shapes`` every subject pads to the cohort's
    (max files, max frames), frames in common (zip-truncated) units when
    ``context`` is set; eager callers may omit the pads, a lazy iterable
    must give both. A subject larger than the declared pads still
    computes correctly at its own shape. Returns {subject: SweepResult}
    with the padding sliced away.

    The loop is the JAX package's depth-2 pipeline (_pipelined_sweep).
    With a ``mesh`` of more than one rank (a collective call: every rank
    passes the same cohort), ``subject_parallel`` shards the subject axis
    over the ranks (_subject_parallel_sweep), the layout for ranks that
    each hold whole subjects; without it subjects run in series and the
    mesh shards each subject's file axis instead, the layout for a
    subject too large for one device. Every rank returns every subject.
    With ``subject_parallel`` a rank may pass only its own share of the
    cohort, cohort_names[rank::W], and ``cohort_names`` the whole
    cohort's names in order, so that no rank reads another's subjects;
    the pads are then the largest of every rank's (given or derived).
    """
    device = device_policy.resolve(device)
    if hasattr(subjects, 'items'):
        items = list(subjects.items())
    elif isinstance(subjects, (list, tuple)):
        items = list(subjects)
    else:
        items = None   # Lazy iterable: consume subject by subject.
    # With a context spec the arrays are raw and pad_frames_to is in
    # common-axis units: n_i = raw x length - x_post.
    x_post = context.x_post if context is not None else 0
    want_parallel = (subject_parallel and mesh is not None
                     and mesh.size > 1)
    if items is None:
        if (shared_shapes or want_parallel) and (
                pad_files_to is None or pad_frames_to is None):
            raise ValueError(
                'multi_subject_sweep got a lazy subject iterable: '
                'shared program shapes cannot be derived without '
                'materializing every subject, so pass pad_files_to '
                'AND pad_frames_to explicitly (or pass a dict/list).')
        items = subjects
    elif (shared_shapes and len(items) > 1) or want_parallel:
        if pad_files_to is None:
            pad_files_to = max((len(xs) for _, (xs, _) in items), default=0)
        if pad_frames_to is None:
            pad_frames_to = max((x.shape[0] for _, (xs, _) in items
                                 for x in xs), default=x_post) - x_post
    if want_parallel and cohort_names is not None:
        # Each rank holds its share only: the cohort's pads are the
        # largest of every rank's.
        pad_files_to, pad_frames_to = (int(p) for p in mesh_lib.gather(
            np.asarray([pad_files_to, pad_frames_to]), mesh).max(0))
    if want_parallel:
        return _subject_parallel_sweep(items, lambdas, model, mesh,
                                       use_ridge, pad_files_to,
                                       pad_frames_to, context, device,
                                       cohort_names)
    return _pipelined_sweep(items, lambdas, model, use_ridge, pad_files_to,
                            pad_frames_to, context, device, mesh)


def cohort_summary(results) -> Tuple[np.ndarray, np.ndarray]:
    """Mean/std correlation per lambda across all subjects' held-out
    files (the codelab's cross-subject analysis)."""
    all_corr = np.concatenate([r.correlations for r in results.values()],
                              axis=1)
    return np.mean(all_corr, axis=1), np.std(all_corr, axis=1)


def default_mesh(axis_name: str = 'file', device='cuda'
                 ) -> Optional[mesh_lib.Mesh]:
    """A 1-D mesh over the initialized process group (None without a
    group or with a group of one rank, so one process keeps its serial
    paths)."""
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return mesh_lib.create_mesh((axis_name,), device=device)
    return None
