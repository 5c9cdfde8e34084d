"""Kernel T1: a deep CCA decoder's two towers on a served chunk, in one
launch (csrc/dcca_towers.cu).

The towers of ``models/cca.py::BrainModelDCCA`` are dense ReLU stacks,
``relu(... relu(x W0 + b0) ...) W_last + b_last``, the first on the EEG
rows x1 [R, F1], the second on each audio stream's rows [R, F2]. T1
replaces no TPU kernel: the JAX package leaves its towers to XLA's dense
layers. It takes the place of the cuBLAS products, bias adds and ReLUs
that a served push otherwise launches one by one (about 25 of them).

  * dcca_towers_reference: plain torch, the same operations in the same
    order as the model's own stack (``x @ w + b``, then ``relu``).
  * TowerWeights: both towers' layers as the plain version reads them
    and, for weights on the card within T1's limits, one buffer packed
    once in the layout T1 reads (every width zero-padded) and the scratch
    where the EEG tower's clusters meet, which it holds alive at their
    addresses; and T1's launch plan per call signature.
  * dcca_towers: the wrapper. CPU tensors take the plain version; CUDA
    tensors launch T1 once or raise. Launches count in
    ``kernels.launches['dcca_towers']``.

T1's limits (``TowerWeights.fits``, ``launches``): 1 to 64 rows a stream,
one or two audio streams; one or two hidden layers, each at most 256
wide; at most 16 output dimensions; and a block's shared memory at 64
rows (its slice of the inputs, and the later layers' weights: the
codelab's 128-64 towers take 152 KB of the 227 KB; 256-64 fits, 256-128
does not).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from telluride_decoding_torch import kernels

MAX_ROWS = 64
MAX_HIDDEN = 256
MAX_DIMS = 16
# Must match namespace towers in csrc/dcca_towers.cu.
CLUSTER = 16
_THREADS = 256
_STAGES = 8
_TILE = 8
_MAX_CHUNK = 64
_MAX_LAYERS = 3
_MAX_SMEM_BYTES = 232448
# The fewest inputs a block's slice of the first layer takes within one
# cluster and spread over several, the most clusters, and the most rows
# of a row group.
_MIN_SLICE = 64
_MIN_SPREAD_SLICE = 32
_MAX_CLUSTERS = 4
_MAX_GROUP_ROWS = 64

Layers = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


class _Tower(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in (
        'width', 'streams', 'clusters', 'kslices', 'slice', 'chunk',
        'group_rows', 'w0', 'later')]


class TowerPlan(ctypes.Structure):
    """T1's launch plan (Plan in csrc/dcca_towers.cu, the same fields in
    the same order), one per call signature (rows, audio streams)."""

    _fields_ = ([(name, ctypes.c_int) for name in (
        'rows', 'depth', 'dims', 'cluster')] +
        [('widths', ctypes.c_int * _MAX_LAYERS), ('tower', _Tower * 2)])


def _round_up(value: int, unit: int) -> int:
    return -(-value // unit) * unit


def smem_bytes(widths: Sequence[int], slice_: int, chunk: int,
               group_rows: int, kslices: int) -> int:
    """Dynamic shared memory of one block of a tower (towers::layout in
    csrc/dcca_towers.cu): up to eight slots of a chunk of W0's rows, which
    the k-groups' partials overwrite; the group's rows of the slice; the
    partial products of the owned rows, a slot a slice; the run b0, W1,
    b1, ...; two buffers of the owned rows' activations; the mbarriers
    and a count.
    ``widths``: the padded output widths of the layers."""
    h0 = widths[0]
    mp = _round_up(group_rows, _TILE)
    owned = -(-group_rows // kslices)
    kgroups = _THREADS // (mp // _TILE * (h0 // _TILE))
    slots = min(_STAGES, -(-slice_ // chunk))
    floats = (max(slots * _round_up(chunk, 4) * h0, kgroups * mp * h0) +
              mp * (_round_up(slice_ + 3, 8) + 4) + kslices * owned * h0 +
              h0)
    for w_in, w_out in zip(widths[:-1], widths[1:]):
        floats += (w_in + 1) * w_out
    floats += 2 * owned * max(widths)
    return 4 * (_round_up(floats, 2) + 2 * (_STAGES + 3))


def _split(width: int, total_rows: int,
           spread: bool) -> Tuple[int, int, int, int]:
    """(clusters, kslices, slice, group_rows) of a tower's first layer.
    With ``spread`` (the EEG tower) wide inputs, at least 32 a block, are
    split over two or four whole clusters, one row group; otherwise one
    cluster splits them in as many slices (a power of two up to the
    cluster) as leave each at least _MIN_SLICE inputs and each row group
    at most _MAX_GROUP_ROWS rows, the rows in cluster / kslices groups."""
    if spread and total_rows <= _MAX_GROUP_ROWS:
        for clusters in (_MAX_CLUSTERS, 2):
            if width >= clusters * CLUSTER * _MIN_SPREAD_SLICE:
                return (clusters, CLUSTER, -(-width // (clusters * CLUSTER)),
                        total_rows)
    ks = CLUSTER
    while ks > 1 and (width < ks * _MIN_SLICE or
                      -(-total_rows // (CLUSTER // ks)) > _MAX_GROUP_ROWS):
        ks //= 2
    return 1, ks, -(-width // ks), -(-total_rows // (CLUSTER // ks))


def _chunk(widths: Sequence[int], slice_: int, group_rows: int,
           kslices: int) -> Optional[int]:
    """Inputs a chunk: the widest of 64, 32, ... 4 (or the whole slice
    where it is shorter) whose slots, up to eight, fit the block's shared
    memory."""
    chunk = _MAX_CHUNK
    while chunk >= 4:
        if smem_bytes(widths, slice_, min(chunk, slice_), group_rows,
                      kslices) <= _MAX_SMEM_BYTES:
            return min(chunk, slice_)
        chunk //= 2
    return None


def _mlp(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    for i, (w, b) in enumerate(layers):
        x = x @ w + b
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


class TowerWeights:
    """Both towers' layers, each a sequence of (w [in, out], b [out])
    float32 tensors on one device, the audio tower's hidden and output
    widths the EEG tower's. On the card, within T1's limits, ``packed``
    holds them in T1's layout (packed once, here); else it is None."""

    def __init__(self, tower1: Layers, tower2: Layers):
        self.tower1, self.tower2 = tuple(tower1), tuple(tower2)
        self.depth = len(self.tower1)
        self.widths_in = (self.tower1[0][0].shape[0],
                          self.tower2[0][0].shape[0])
        outs = [w.shape[1] for w, _ in self.tower1]
        self.dims = outs[-1]
        self.widths = tuple([_round_up(outs[0], 32)] +
                            [_round_up(w, 4) for w in outs[1:]])
        self.packed: Optional[torch.Tensor] = None
        self._offsets = ((), ())
        self._plans = {}
        if self.fits() and self.tower1[0][0].device.type == 'cuda':
            self.packed, self._offsets = self._pack()
            # Where the clusters of the EEG tower's first layer leave their
            # sums, and how many have arrived (left at 0 by each launch).
            device = self.packed.device
            self._scratch = torch.empty(
                _MAX_CLUSTERS * MAX_ROWS * self.widths[0],
                dtype=torch.float32, device=device)
            self._arrivals = torch.zeros(CLUSTER, dtype=torch.int32,
                                         device=device)

    def fits(self) -> bool:
        """Whether T1 takes these towers' widths (on any device), at up to
        MAX_ROWS rows a stream."""
        outs = [w.shape[1] for w, _ in self.tower1]
        if not (2 <= self.depth <= _MAX_LAYERS
                and all(o <= MAX_HIDDEN for o in outs[:-1])
                and 1 <= self.dims <= MAX_DIMS
                and [w.shape[1] for w, _ in self.tower2] == outs):
            return False
        return self._towers(MAX_ROWS, 2) is not None

    def launches(self, rows: int) -> bool:
        """Whether ``dcca_towers`` launches T1 on a call of ``rows`` rows
        a stream: the weights are packed on the card and T1 takes it."""
        return self.packed is not None and 1 <= rows <= MAX_ROWS

    def _towers(self, rows: int, streams: int) -> Optional[list]:
        """Each tower's (clusters, kslices, slice, chunk, group_rows) at
        ``rows`` rows a stream and ``streams`` audio streams (the audio
        tower in one cluster); None where a block's shared memory cannot
        hold a chunk."""
        towers = []
        for width, n, spread in zip(self.widths_in, (1, streams),
                                    (True, False)):
            clusters, ks, slice_, group_rows = _split(width, n * rows, spread)
            chunk = _chunk(self.widths, slice_, group_rows, ks)
            if chunk is None:
                return None
            towers.append((clusters, ks, slice_, chunk, group_rows))
        return towers

    def _pack(self):
        """One buffer, each tower's W0 [F, H0p] and then its run b0, W1,
        b1, ..., every width zero-padded; each tower's (W0, run)
        offsets."""
        device = self.tower1[0][0].device
        parts, offsets, at = [], [], 0
        for layers in (self.tower1, self.tower2):
            rows = layers[0][0].shape[0]
            for i, (w, b) in enumerate(layers):
                cols = self.widths[i]
                padded = torch.zeros((rows, cols), dtype=torch.float32,
                                     device=device)
                padded[:w.shape[0], :w.shape[1]] = w
                bias = torch.zeros(cols, dtype=torch.float32, device=device)
                bias[:b.shape[0]] = b.reshape(-1)
                if i == 0:
                    offsets.append((at, at + padded.numel()))
                parts += [padded.reshape(-1), bias]
                at += padded.numel() + cols
                rows = cols
        return torch.cat(parts), tuple(offsets)

    def plan(self, rows: int, streams: int) -> TowerPlan:
        """T1's plan for ``rows`` rows a stream and ``streams`` audio
        streams, kept per signature."""
        key = (rows, streams)
        found = self._plans.get(key)
        if found is None:
            towers = [
                _Tower(width, n, clusters, ks, slice_, chunk, group_rows, w0,
                       later)
                for width, n, (clusters, ks, slice_, chunk, group_rows),
                (w0, later) in zip(self.widths_in, (1, streams),
                                   self._towers(rows, streams),
                                   self._offsets)]
            widths = list(self.widths) + [0] * (_MAX_LAYERS - self.depth)
            found = self._plans[key] = TowerPlan(
                rows, self.depth, self.dims, CLUSTER,
                (ctypes.c_int * _MAX_LAYERS)(*widths), (_Tower * 2)(*towers))
        return found


def dcca_towers_reference(weights: TowerWeights, x1: torch.Tensor,
                          x2s: Sequence[torch.Tensor]
                          ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Plain torch: (tower1(x1), [tower2(x2) for each stream])."""
    return _mlp(weights.tower1, x1), [_mlp(weights.tower2, x2) for x2 in x2s]


def _check(weights: TowerWeights, x1: torch.Tensor,
           x2s: Sequence[torch.Tensor]) -> Tuple[int, int]:
    """(rows, audio streams) of a call T1 takes; raises on any other."""
    if weights.packed is None:
        raise ValueError('dcca_towers: these towers are not packed for T1 '
                         '(weights off the card, or widths %s / depth %d / '
                         '%d dims outside its limits).'
                         % (list(weights.widths), weights.depth,
                            weights.dims))
    tensors = [x1, *x2s]
    device = weights.packed.device
    if any(t.device != device for t in tensors):
        raise ValueError('dcca_towers needs its inputs on %s, got %s.'
                         % (device, sorted({str(t.device) for t in tensors})))
    rows = x1.shape[0] if x1.dim() == 2 else -1
    f1, f2 = weights.widths_in
    if not (1 <= len(x2s) <= 2 and 1 <= rows <= MAX_ROWS
            and tuple(x1.shape) == (rows, f1)
            and all(tuple(x.shape) == (rows, f2) for x in x2s)):
        raise ValueError('dcca_towers takes x1 [R, %d] and one or two x2 '
                         '[R, %d] with 1 <= R <= %d, got %s and %s.'
                         % (f1, f2, MAX_ROWS, tuple(x1.shape),
                            [tuple(x.shape) for x in x2s]))
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors):
        raise ValueError('dcca_towers takes contiguous float32 inputs.')
    return rows, len(x2s)


def dcca_towers(weights: TowerWeights, x1: torch.Tensor,
                x2s: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Both towers: (h1 [R, D], [h2 [R, D] for each audio stream]).

    CPU tensors take dcca_towers_reference. CUDA tensors launch T1 once
    or raise (ValueError): the weights packed on their card, x1 [R, F1]
    and one or two x2 [R, F2] contiguous float32 on it, R <= MAX_ROWS.
    The audio streams' outputs are views of one [streams, R, D] tensor.
    """
    if x1.device.type == 'cpu':
        return dcca_towers_reference(weights, x1, x2s)
    rows, streams = _check(weights, x1, x2s)
    plan = weights.plan(rows, streams)
    h1 = torch.empty((rows, weights.dims), dtype=torch.float32,
                     device=x1.device)
    h2 = torch.empty((streams, rows, weights.dims), dtype=torch.float32,
                     device=x1.device)
    code = kernels.library().tdt_dcca_towers(
        x1.data_ptr(), x2s[0].data_ptr(),
        x2s[1].data_ptr() if streams == 2 else None,
        weights.packed.data_ptr(), h1.data_ptr(), h2.data_ptr(),
        weights._scratch.data_ptr(), weights._arrivals.data_ptr(),
        ctypes.addressof(plan), kernels.stream_handle(x1.device))
    kernels.check(code, 'dcca_towers')
    return h1, list(h2.unbind(0))
