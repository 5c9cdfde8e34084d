"""Kernel R1: a regression decoder's served call in one launch: the
prediction, each talker's correlation with it and the scaled LDA
(csrc/regression_push.cu).

A ``LinearRegressionDecoder`` whose model reads input_1 alone scores a
call as ``pred = model(x1)``, then, for each talker's envelope y_k,
``slope * ((((y_k - mean_x) * (pred - mean_y)) / power) @ lda_w)[:, 0] +
intercept`` (``Decoder._build_pipeline``'s ``correlate_reduce`` with the
'lda' reduction). Where the model's prediction is a dense ReLU stack,
``relu(... relu(x W0 + b0) ...) W_last + b_last`` (``dense_layers()``:
the fullyconnected regressor without batch norm, the linear regressor as
a stack of one layer), R1 computes all of it in one launch. It replaces
no TPU kernel: the JAX package leaves the composition to XLA. It takes
the place of the cuBLAS products, bias adds, ReLUs and elementwise
kernels that a served push otherwise launches one by one (about 23).

  * regression_push_reference: plain torch, the same operations in the
    same order as the model's own stack and ``correlate_reduce``.
  * RegressionWeights: the layers, the statistics and the LDA as the plain
    version reads them and, on the card within R1's limits, one buffer
    packed once in the layout R1 reads (every width zero-padded); and R1's
    launch plan per call signature.
  * regression_push: the wrapper. CPU tensors take the plain version; CUDA
    tensors launch R1 once or raise. Launches count in
    ``kernels.launches['regression_push']``.

R1's limits (``RegressionWeights.fits``, ``launches``): 1 to 64 rows, one
or two talkers whose envelopes have 1 or ``out`` columns; one to four
layers, hidden widths at most 64, an output width at most 16; and a
block's shared memory at 64 rows (its slice of W0 and of x, the run).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from telluride_decoding_torch import kernels

MAX_ROWS = 64
MAX_HIDDEN = 64
MAX_OUT = 16
MAX_LAYERS = 4
# Must match namespace regression in csrc/regression_push.cu.
CLUSTER = 16
_THREADS = 256
_MAX_SMEM_BYTES = 232448
# The fewest inputs a block's slice of the first layer takes, where the
# inputs allow.
_MIN_SLICE = 32

Layers = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


class RegressionPlan(ctypes.Structure):
    """R1's launch plan (Plan in csrc/regression_push.cu, the same fields
    in the same order), one per call signature (rows, talkers, envelope
    columns)."""

    _fields_ = ([(name, ctypes.c_int) for name in (
        'rows', 'streams', 'width', 'depth', 'out', 'ycols', 'cluster',
        'slice', 'run', 'run_floats')] +
        [('widths', ctypes.c_int * MAX_LAYERS)])


def _round_up(value: int, unit: int) -> int:
    return -(-value // unit) * unit


def cluster_size(width: int) -> int:
    """Blocks of R1's cluster for ``width`` inputs: the most, a power of
    two up to CLUSTER, that leave each slice at least _MIN_SLICE inputs;
    one below that."""
    cluster = CLUSTER
    while cluster > 1 and width < cluster * _MIN_SLICE:
        cluster //= 2
    return cluster


def run_floats(widths: Sequence[int]) -> int:
    """Floats of the packed run: b0, then each later layer's [in, out]
    and bias, then mean_x, mean_y, power and lda_w at the last width,
    slope, intercept and two zeros."""
    floats = widths[0]
    for w_in, w_out in zip(widths[:-1], widths[1:]):
        floats += (w_in + 1) * w_out
    return floats + 4 * widths[-1] + 4


def smem_bytes(widths: Sequence[int], rows: int, slice_: int,
               cluster: int) -> int:
    """Dynamic shared memory of one block (regression::layout in
    csrc/regression_push.cu): its slice of W0; the slice of every row of x
    at an odd pitch; the k-groups' partial products; the run; two buffers
    of the owned rows' activations; two mbarriers.
    ``widths``: the padded output widths of the layers."""
    h0 = widths[0]
    rp = _round_up(rows, 4)
    kgroups = _THREADS // (rp // 4 * (h0 // 4))
    owned = -(-rows // cluster)
    floats = (slice_ * h0 + _round_up(rp * (slice_ | 1), 4) +
              kgroups * rp * h0 + run_floats(widths) +
              2 * owned * max(widths))
    return 4 * (_round_up(floats, 2) + 4)


def _mlp(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    for i, (w, b) in enumerate(layers):
        x = x @ w + b
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


class RegressionWeights:
    """A regression decoder's served composition: the model's layers, a
    sequence of (w [in, out], b [out]) float32 tensors on one device, and
    the statistics and LDA ``correlate_reduce`` reads (mean_x, mean_y and
    power of one or ``out`` values, lda_w [out, k], slope and intercept of
    one). On the card, within R1's limits, ``packed`` holds them in R1's
    layout (packed once, here); else it is None."""

    def __init__(self, layers: Layers, mean_x: torch.Tensor,
                 mean_y: torch.Tensor, power: torch.Tensor,
                 lda_w: torch.Tensor, lda_slope: torch.Tensor,
                 lda_intercept: torch.Tensor):
        self.layers = tuple(layers)
        self.stats = (mean_x, mean_y, power, lda_w, lda_slope, lda_intercept)
        self.depth = len(self.layers)
        self.width = self.layers[0][0].shape[0]
        self.out = self.layers[-1][0].shape[1]
        self.widths = tuple(_round_up(w.shape[1], 4) for w, _ in self.layers)
        self.cluster = cluster_size(self.width)
        self.slice = -(-self.width // self.cluster)
        self.packed: Optional[torch.Tensor] = None
        self._plans = {}
        if self.fits() and self.layers[0][0].device.type == 'cuda':
            self.packed = self._pack()

    def fits(self) -> bool:
        """Whether R1 takes these layers and statistics (on any device),
        at up to MAX_ROWS rows."""
        outs = [w.shape[1] for w, _ in self.layers]
        ins = [w.shape[0] for w, _ in self.layers]
        mean_x, mean_y, power, lda_w, slope, intercept = self.stats
        if not (1 <= self.depth <= MAX_LAYERS
                and ins[1:] == outs[:-1]
                and all(1 <= o <= MAX_HIDDEN for o in outs[:-1])
                and 1 <= self.out <= MAX_OUT
                and all(b.numel() == o for (_, b), o in zip(self.layers,
                                                            outs))
                and all(t.numel() in (1, self.out)
                        for t in (mean_x, mean_y, power))
                and lda_w.dim() == 2 and lda_w.shape[0] == self.out
                and slope.numel() == 1 and intercept.numel() == 1):
            return False
        return smem_bytes(self.widths, MAX_ROWS, self.slice,
                          self.cluster) <= _MAX_SMEM_BYTES

    def launches(self, rows: int) -> bool:
        """Whether ``regression_push`` launches R1 on a call of ``rows``
        rows: the weights are packed on the card and R1 takes it."""
        return self.packed is not None and 1 <= rows <= MAX_ROWS

    def _pack(self) -> torch.Tensor:
        """One buffer: W0 [F, H0p], then the run b0, W1, b1, ..., mean_x,
        mean_y, power, lda_w[:, 0] at the last width, slope, intercept and
        two zeros; every width zero-padded (power with ones)."""
        device = self.layers[0][0].device

        def padded(t, shape, fill=0.0):
            out = torch.full(shape, fill, dtype=torch.float32, device=device)
            out[tuple(slice(0, n) for n in t.shape)] = t
            return out.reshape(-1)
        parts = [padded(self.layers[0][0], (self.width, self.widths[0]))]
        ins = self.widths[0]
        for i, (w, b) in enumerate(self.layers):
            if i:
                parts.append(padded(w, (ins, self.widths[i])))
            parts.append(padded(b.reshape(-1), (self.widths[i],)))
            ins = self.widths[i]
        mean_x, mean_y, power, lda_w, slope, intercept = self.stats
        for t, fill in ((mean_x, 0.0), (mean_y, 0.0), (power, 1.0)):
            parts.append(padded(torch.broadcast_to(t.reshape(-1),
                                                   (self.out,)),
                                (ins,), fill))
        parts += [padded(lda_w[:, 0], (ins,)), slope.reshape(1).float(),
                  intercept.reshape(1).float(),
                  torch.zeros(2, dtype=torch.float32, device=device)]
        return torch.cat(parts)

    def plan(self, rows: int, streams: int, ycols: int) -> RegressionPlan:
        """R1's plan for ``rows`` rows, ``streams`` talkers and envelopes
        of ``ycols`` columns, kept per signature."""
        key = (rows, streams, ycols)
        found = self._plans.get(key)
        if found is None:
            widths = list(self.widths) + [0] * (MAX_LAYERS - self.depth)
            found = self._plans[key] = RegressionPlan(
                rows, streams, self.width, self.depth, self.out, ycols,
                self.cluster, self.slice, self.width * self.widths[0],
                run_floats(self.widths),
                (ctypes.c_int * MAX_LAYERS)(*widths))
        return found


def regression_push_reference(weights: RegressionWeights, x1: torch.Tensor,
                              ys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain torch: the scores [talkers, R] of the prediction of x1
    against each talker's envelope, as the model's stack and
    ``correlate_reduce`` compute them."""
    prediction = _mlp(weights.layers, x1)
    mean_x, mean_y, power, lda_w, slope, intercept = weights.stats
    return torch.stack([
        slope * (((y - mean_x) * (prediction - mean_y) / power) @
                 lda_w)[:, 0] + intercept for y in ys])


def _check(weights: RegressionWeights, x1: torch.Tensor,
           ys: Sequence[torch.Tensor]) -> Tuple[int, int]:
    """(rows, envelope columns) of a call R1 takes; raises on any
    other."""
    if weights.packed is None:
        raise ValueError('regression_push: these layers are not packed for '
                         'R1 (weights off the card, or widths %s / depth %d '
                         '/ %d outputs outside its limits).'
                         % (list(weights.widths), weights.depth, weights.out))
    tensors = [x1, *ys]
    device = weights.packed.device
    if any(t.device != device for t in tensors):
        raise ValueError('regression_push needs its inputs on %s, got %s.'
                         % (device, sorted({str(t.device) for t in tensors})))
    rows = x1.shape[0] if x1.dim() == 2 else -1
    ycols = ys[0].shape[-1] if ys else -1
    if not (1 <= len(ys) <= 2 and 1 <= rows <= MAX_ROWS
            and tuple(x1.shape) == (rows, weights.width)
            and ycols in (1, weights.out)
            and all(tuple(y.shape) == (rows, ycols) for y in ys)):
        raise ValueError('regression_push takes x1 [R, %d] and one or two '
                         'envelopes [R, 1 or %d] with 1 <= R <= %d, got %s '
                         'and %s.' % (weights.width, weights.out, MAX_ROWS,
                                      tuple(x1.shape),
                                      [tuple(y.shape) for y in ys]))
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors):
        raise ValueError('regression_push takes contiguous float32 inputs.')
    return rows, ycols


def regression_push(weights: RegressionWeights, x1: torch.Tensor,
                    ys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The scores [talkers, R] of the prediction of x1 [R, F] against each
    talker's envelope y [R, 1 or out].

    CPU tensors take regression_push_reference. CUDA tensors launch R1
    once or raise (ValueError): the weights packed on their card, x1 and
    one or two envelopes contiguous float32 on it, R <= MAX_ROWS.
    """
    if x1.device.type == 'cpu':
        return regression_push_reference(weights, x1, ys)
    rows, ycols = _check(weights, x1, ys)
    plan = weights.plan(rows, len(ys), ycols)
    scores = torch.empty((len(ys), rows), dtype=torch.float32,
                         device=x1.device)
    code = kernels.library().tdt_regression_push(
        x1.data_ptr(), ys[0].data_ptr(),
        ys[1].data_ptr() if len(ys) == 2 else None,
        weights.packed.data_ptr(), scores.data_ptr(),
        ctypes.addressof(plan), kernels.stream_handle(x1.device))
    kernels.check(code, 'regression_push')
    return scores
