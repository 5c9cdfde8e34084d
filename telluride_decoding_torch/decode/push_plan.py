"""Resident push plans: a served pair's copy in, the decoder's own
composition of a push and copy out as one CUDA graph (the port's own;
the JAX package dispatches a served chunk as one jitted executable and
has no counterpart).

A synchronous ``Decoder.infer_pair`` of host arrays on the card
otherwise pays, every push, for three blocking copies from pageable
memory (five for a regression decoder, which also reads each talker's
envelope), the launch path of each kernel and product it runs and two
blocking reads. A ``PushPlan`` captures a function ``run`` of the
inputs it stages on the card (the three streams' frames, then a
regression decoder's two envelopes), which gives the [2, rows] scores
(the decoder hands it ``Decoder._scores_on`` of one pipeline and each
stream's lags, which the eager path runs too), and holds:

  * one pinned host staging buffer holding those blocks packed, each
    from a 256-byte boundary, and the device buffer it is copied to,
    whose views ``run`` reads;
  * the [2, rows] scores on the card and a pinned host copy of them;
  * a CUDA graph of the staging buffer's copy to the card, ``run`` and
    the scores' copy back, then a record of one CUDA event (an external
    event: each replay records it, and the host needs no stream object
    to wait on it);
  * ``run``, and with it whatever memory the graph reads.

A push copies its inputs into the staging buffer with numpy, replays the
graph and waits on the event once: the same scores as ``run`` gives
without a plan on the same inputs, bit for bit. The launches that the
capture counted in ``kernels.launches`` are wound back, since a capture
runs nothing, and each replay counts them again. ``PushPlans`` keeps a
decoder's plans.
"""

from __future__ import annotations

import collections
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from telluride_decoding_torch import kernels
from telluride_decoding_torch.utils import profiling

# Each packed input starts on a 256-byte boundary (64 floats).
_ALIGN = 64


class PushPlan:
    """One captured push of ``run`` on staged inputs of ``frame_shapes``
    (one a stream: input_1, input_2a, input_2b; then, for a regression
    decoder, output_a and output_b) giving [2, rows] scores."""

    def __init__(self, run: Callable[[List[torch.Tensor]], torch.Tensor],
                 frame_shapes: Sequence[Tuple[int, int]], rows: int,
                 device: torch.device):
        self._device = device
        self._run = run    # Holds what the graph reads.
        sizes = [n * w for n, w in frame_shapes]
        starts = np.cumsum([0] + [-(-size // _ALIGN) * _ALIGN
                                  for size in sizes])
        self._staging = torch.empty(int(starts[-1]), dtype=torch.float32,
                                    pin_memory=True)
        self._inputs = torch.empty(int(starts[-1]), dtype=torch.float32,
                                   device=device)
        staged = self._staging.numpy()
        self._host_inputs = [staged[s:s + size].reshape(shape) for s, size,
                             shape in zip(starts, sizes, frame_shapes)]
        views = [self._inputs[s:s + size].view(shape) for s, size, shape
                 in zip(starts, sizes, frame_shapes)]
        self._host_scores = torch.empty((2, rows), dtype=torch.float32,
                                        pin_memory=True)
        self._host_rows = self._host_scores.numpy()
        self._done = torch.cuda.Event(external=True)
        self._graph = torch.cuda.CUDAGraph()
        before = kernels.launches.copy()
        with torch.cuda.device(device), torch.no_grad(), torch.cuda.graph(
                self._graph, capture_error_mode='thread_local'):
            self._inputs.copy_(self._staging, non_blocking=True)
            self._scores = run(views)
            self._host_scores.copy_(self._scores, non_blocking=True)
            self._done.record()
        # A capture records the launches and runs nothing; replays count.
        self._launches = kernels.launches - before
        kernels.launches.subtract(self._launches)
        profiling.count(profiling.GRAPH_CAPTURES)

    def run(self, frames: Sequence[np.ndarray]
            ) -> Tuple[np.ndarray, np.ndarray]:
        """The two score rows of one push of host ``frames`` (every
        staged input) of the plan's shapes; one wait on the card."""
        with profiling.span('decoder.copy_in'):
            for host, value in zip(self._host_inputs, frames):
                np.copyto(host, value)
        with profiling.span('decoder.launch'):
            self._graph.replay()
            kernels.launches.update(self._launches)
            profiling.count(profiling.GRAPH_REPLAYS)
        with profiling.span('decoder.copy_out'):
            profiling.host_wait(self._device)
            self._done.synchronize()
            return self._host_rows[0].copy(), self._host_rows[1].copy()


class PushPlans:
    """A decoder's resident push plans: an LRU of ``SIZE``, keyed by
    whatever the decoder names a plan by.

    A key's plan is captured the second time the key is seen: ``saw``
    marks the first sight, which the decoder serves without a plan, so a
    chunk length met once (a stream's first push, an odd chunk) costs no
    capture.
    """

    SIZE = 4
    SEEN_SIZE = 64

    def __init__(self):
        self._plans = collections.OrderedDict()
        self._seen = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._plans)

    def plan(self, key: tuple,
             capture: Callable[[], PushPlan]) -> Optional[PushPlan]:
        """The plan of ``key``, made by ``capture()`` now if the key was
        seen before; None on its first sight."""
        hit = self._plans.get(key)
        if hit is not None:
            self._plans.move_to_end(key)
            return hit
        if self._seen.pop(key, None) is None:
            return None
        plan = self._plans[key] = capture()
        while len(self._plans) > self.SIZE:
            self._plans.popitem(last=False)
        return plan

    def saw(self, key: tuple):
        """Marks ``key`` as served once without a plan."""
        self._seen[key] = True
        self._seen.move_to_end(key)
        while len(self._seen) > self.SEEN_SIZE:
            self._seen.popitem(last=False)
