"""Resident push plans: a served pair's copy in, a deep CCA model's
towers, kernel K1 and copy out as one CUDA graph (the port's own; the
JAX package dispatches a served chunk as one jitted executable and has
no counterpart).

A synchronous ``Decoder.infer_pair`` of host arrays on the card, to a
CCA or deep CCA decoder with the LDA reduction, otherwise pays, every
push, for three blocking copies from pageable memory, a deep CCA model's
eager tower launches (a product and a bias add a layer, a ReLU after
each hidden one, for each of the three streams), K1's launch path (the
pipeline check, the plan lookup, an allocation, ctypes and the cluster
launch) and two blocking reads. A ``PushPlan`` holds, for one (rows, F1,
F2, kernel operands, each stream's window):

  * one pinned host staging buffer holding x1 | x2a | x2b packed, each
    part from a 256-byte boundary, and the device buffer it is copied to;
    each part holds a stream's raw frames [pre + rows + post, C]
    (``LagRows``, the serving loop's windows: 19.3 KB a 32-frame push at
    codelab widths against 335 KB of stacked rows); a host array is a
    window with no context, its rows its own frames;
  * the [2, rows] scores on the card and a pinned host copy of them;
  * a CUDA graph of the staging buffer's copy to the card, the lag stack
    of each window with context (kernel K2, ``lagstack.lag_stack``, one
    launch a window), for a deep CCA model its three tower passes (the decoder's own ``_towers``
    function, the products in float32 with TF32 off, bias adds and
    ReLUs as without a plan, on weights the function holds), K1's
    launch (``fused_cca_decode``, the launch the decoder makes without a
    plan, with the same launch plan and operands) and the scores' copy
    back, then a record of one CUDA event (an external event: each
    replay records it, and the host needs no stream object to wait on
    it).

A push copies its inputs into the staging buffer with numpy, replays the
graph and waits on the event once: the same scores as the path without a
plan on the same inputs, weights and operands, bit for bit (a lag stack
is a copy). ``PushPlans`` keeps a decoder's plans.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from telluride_decoding_torch.ops import decode_kernel, lagstack
from telluride_decoding_torch.utils import profiling

# Each packed input starts on a 256-byte boundary (64 floats).
_ALIGN = 64


class PushPlan:
    """One captured push of ``rows`` frames of F1 + 2 x F2 columns on
    ``operands``, the kernel form of ``folded`` that prepared_operands
    gave last (so the capture's launch reads them). ``towers``, where
    given, maps the inputs to what K1 rotates, ``(x1, [x2a, x2b]) ->
    (h1, [h2a, h2b])``, and holds the weights it reads. ``windows`` is
    ((C, pre, post) of input_1, of the input_2 streams): the raw frames
    that are staged and stacked on the card ((F, 0, 0) for host arrays
    of F columns)."""

    def __init__(self, folded: decode_kernel.FoldedDecode,
                 operands: decode_kernel.PreparedOperands, rows: int,
                 f1: int, f2: int, device: torch.device,
                 towers: Optional[Callable], windows: tuple):
        self._device = device
        # The memory the graph reads, alive as long as the graph: K1's
        # operands, and the towers' weights through the function.
        self._operands = operands
        self._towers = towers
        lags = (windows[0], windows[1], windows[1])
        shapes = [(pre + rows + post, c) for c, pre, post in lags]
        sizes = [n * w for n, w in shapes]
        starts = np.cumsum([0] + [-(-size // _ALIGN) * _ALIGN
                                  for size in sizes])
        self._staging = torch.empty(int(starts[-1]), dtype=torch.float32,
                                    pin_memory=True)
        self._inputs = torch.empty(int(starts[-1]), dtype=torch.float32,
                                   device=device)
        staged = self._staging.numpy()
        self._host_inputs = [staged[s:s + size].reshape(shape)
                             for s, size, shape in zip(starts, sizes, shapes)]
        x1, x2a, x2b = (self._inputs[s:s + size].view(shape)
                        for s, size, shape in zip(starts, sizes, shapes))
        self._host_scores = torch.empty((2, rows), dtype=torch.float32,
                                        pin_memory=True)
        self._host_rows = self._host_scores.numpy()
        self._done = torch.cuda.Event(external=True)
        self._graph = torch.cuda.CUDAGraph()
        launches = (decode_kernel.fused_cca_decode.launches,
                    lagstack.lag_stack.launches)
        with torch.cuda.device(device), torch.no_grad(), torch.cuda.graph(
                self._graph, capture_error_mode='thread_local'):
            self._inputs.copy_(self._staging, non_blocking=True)
            # Row t of a window's stack with no pre context and pre + post
            # after is the stream's row of frame pre + t: the rows start
            # at the stack's first byte, as aligned as staged rows. The
            # last pre + post rows are never read. No context: no launch.
            x1, x2a, x2b = (
                lagstack.lag_stack(x, 0, pre + post)[:rows]
                for x, (_, pre, post) in zip((x1, x2a, x2b), lags))
            if towers is not None:
                x1, (x2a, x2b) = towers(x1, [x2a, x2b])
            self._scores = decode_kernel.fused_cca_decode(
                folded, x1[:, None], x2a[:, None], x2b[:, None])
            self._host_scores.copy_(self._scores, non_blocking=True)
            self._done.record()
        # A capture records the launches and runs nothing; replays count.
        self._stacks = lagstack.lag_stack.launches - launches[1]
        decode_kernel.fused_cca_decode.launches = launches[0]
        lagstack.lag_stack.launches = launches[1]
        profiling.count(profiling.GRAPH_CAPTURES)

    def run(self, input_1, input_2a, input_2b
            ) -> Tuple[np.ndarray, np.ndarray]:
        """The two score rows of one push (LagRows of the plan's windows,
        or host arrays, their own frames); one wait on the card."""
        with profiling.span('decoder.copy_in'):
            for host, value in zip(self._host_inputs,
                                   (input_1, input_2a, input_2b)):
                np.copyto(host, value.frames
                          if isinstance(value, lagstack.LagRows) else value)
        with profiling.span('decoder.launch'):
            self._graph.replay()
            decode_kernel.fused_cca_decode.launches += 1
            lagstack.lag_stack.launches += self._stacks
            profiling.count(profiling.GRAPH_REPLAYS)
            if self._stacks:
                profiling.count(profiling.DEVICE_STACKS)
            if self._towers is not None:
                profiling.count(profiling.TOWER_PASSES, 3)
        with profiling.span('decoder.copy_out'):
            profiling.host_wait(self._device)
            self._done.synchronize()
            return self._host_rows[0].copy(), self._host_rows[1].copy()


class PushPlans:
    """A decoder's resident push plans: an LRU of ``SIZE``, keyed by
    (rows, F1, F2, the kernel operands' addresses, the windows).

    A key's plan is captured the second time the key is seen: ``saw``
    marks the first sight, which the decoder serves without a plan, so a
    chunk length met once (a stream's first push, an odd chunk) costs no
    capture. An entry holds the operands beside its plan: no eviction
    from prepared_operands' LRU frees memory a live graph reads, and no
    new operands take the addresses of a live key.
    """

    SIZE = 4
    SEEN_SIZE = 64

    def __init__(self):
        self._plans = collections.OrderedDict()
        self._seen = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._plans)

    def plan(self, key: tuple, operands,
             capture: Callable[[], PushPlan]) -> Optional[PushPlan]:
        """The plan of ``key``, made by ``capture()`` now if the key was
        seen before; None on its first sight."""
        hit = self._plans.get(key)
        if hit is not None:
            self._plans.move_to_end(key)
            return hit[1]
        if self._seen.pop(key, None) is None:
            return None
        plan = capture()
        self._plans[key] = (operands, plan)
        while len(self._plans) > self.SIZE:
            self._plans.popitem(last=False)
        return plan

    def saw(self, key: tuple):
        """Marks ``key`` as served once without a plan."""
        self._seen[key] = True
        self._seen.move_to_end(key)
        while len(self._seen) > self.SEEN_SIZE:
            self._seen.popitem(last=False)
