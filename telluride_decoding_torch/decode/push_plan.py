"""Resident push plans: a served pair's copy in, kernel K1 and copy out
as one CUDA graph (the port's own; the JAX package dispatches a served
chunk as one jitted executable and has no counterpart).

A synchronous ``Decoder.infer_pair`` on the card otherwise pays, every
push, for three blocking copies from pageable memory, K1's launch path
(the pipeline check, the plan lookup, an allocation, ctypes and the
cluster launch) and two blocking reads. A ``PushPlan`` holds, for one
(rows, F1, F2, kernel operands):

  * one pinned host staging buffer holding x1 | x2a | x2b packed, each
    part from a 256-byte boundary, and the device buffer it is copied to;
  * the [2, rows] scores on the card and a pinned host copy of them;
  * a CUDA graph of the staging buffer's copy to the card, K1's launch
    (``fused_cca_decode``, the launch the decoder makes without a plan,
    with the same launch plan and operands) and the scores' copy back,
    then a record of one CUDA event (an external event: each replay
    records it, and the host needs no stream object to wait on it).

A push copies its inputs into the staging buffer with numpy, replays the
graph and waits on the event once: K1's scores on the same inputs and
operands, bit for bit. ``PushPlans`` keeps a decoder's plans.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from telluride_decoding_torch.ops import decode_kernel
from telluride_decoding_torch.utils import profiling

# Each packed input starts on a 256-byte boundary (64 floats).
_ALIGN = 64


class PushPlan:
    """One captured push of ``rows`` frames of F1 + 2 x F2 columns on
    ``operands``, the kernel form of ``folded`` that prepared_operands
    gave last (so the capture's launch reads them)."""

    def __init__(self, folded: decode_kernel.FoldedDecode,
                 operands: decode_kernel.PreparedOperands, rows: int,
                 f1: int, f2: int, device: torch.device):
        self._device = device
        # The memory the graph's K1 reads, alive as long as the graph.
        self._operands = operands
        widths = (f1, f2, f2)
        starts = np.cumsum([0] + [-(-rows * w // _ALIGN) * _ALIGN
                                  for w in widths])
        self._staging = torch.empty(int(starts[-1]), dtype=torch.float32,
                                    pin_memory=True)
        self._inputs = torch.empty(int(starts[-1]), dtype=torch.float32,
                                   device=device)
        staged = self._staging.numpy()
        self._host_inputs = [staged[s:s + rows * w].reshape(rows, w)
                             for s, w in zip(starts, widths)]
        x1, x2a, x2b = (self._inputs[s:s + rows * w].view(rows, 1, w)
                        for s, w in zip(starts, widths))
        self._host_scores = torch.empty((2, rows), dtype=torch.float32,
                                        pin_memory=True)
        self._host_rows = self._host_scores.numpy()
        self._done = torch.cuda.Event(external=True)
        self._graph = torch.cuda.CUDAGraph()
        launches = decode_kernel.fused_cca_decode.launches
        with torch.cuda.device(device), torch.cuda.graph(
                self._graph, capture_error_mode='thread_local'):
            self._inputs.copy_(self._staging, non_blocking=True)
            self._scores = decode_kernel.fused_cca_decode(folded, x1, x2a,
                                                          x2b)
            self._host_scores.copy_(self._scores, non_blocking=True)
            self._done.record()
        # A capture records the launch and runs nothing; replays count.
        decode_kernel.fused_cca_decode.launches = launches
        profiling.count(profiling.GRAPH_CAPTURES)

    def run(self, input_1: np.ndarray, input_2a: np.ndarray,
            input_2b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The two score rows of one push (host arrays of the plan's
        shapes); one wait on the card."""
        with profiling.span('decoder.copy_in'):
            for host, value in zip(self._host_inputs,
                                   (input_1, input_2a, input_2b)):
                np.copyto(host, value)
        with profiling.span('decoder.launch'):
            self._graph.replay()
            decode_kernel.fused_cca_decode.launches += 1
            profiling.count(profiling.GRAPH_REPLAYS)
        with profiling.span('decoder.copy_out'):
            profiling.host_wait(self._device)
            self._done.synchronize()
            return self._host_rows[0].copy(), self._host_rows[1].copy()


class PushPlans:
    """A decoder's resident push plans: an LRU of ``SIZE``, keyed by
    (rows, F1, F2, the kernel operands' addresses).

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
