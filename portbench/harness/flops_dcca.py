"""Operations and bytes of a deep CCA decoder's towers, from shapes
alone, by the plain algorithm (as harness/flops.py counts the rest):
each weight and bias read once a pass, the input rows read once, each
layer's output written once; a multiply-add is two operations, a bias
add one, a ReLU one."""

from __future__ import annotations

from typing import Sequence

F32 = 4


def widths(inputs: int, hidden: Sequence[int], dims: int) -> list:
    """A tower's layer widths, input first."""
    return [inputs] + list(hidden) + [dims]


def _layers(sizes):
    return list(zip(sizes[:-1], sizes[1:]))


def tower_bytes(rows: int, sizes: Sequence[int], passes: int = 1) -> int:
    """``passes`` passes of one tower of layer widths ``sizes`` over
    ``rows`` rows in all."""
    params = sum(i * o + o for i, o in _layers(sizes))
    return F32 * (passes * params + rows * sum(sizes))


def tower_flops(rows: int, sizes: Sequence[int]) -> int:
    """One tower over ``rows`` rows: each layer's product and bias add,
    a ReLU after each hidden layer."""
    return rows * (sum(2 * i * o + o for i, o in _layers(sizes)) +
                   sum(sizes[1:-1]))


def pair_bytes(rows: int, f1: int, f2: int, hidden: Sequence[int],
               dims: int, calls: int = 1) -> int:
    """``calls`` pushes over ``rows`` rows in all: the EEG tower once a
    push, the audio tower once for each talker."""
    return (tower_bytes(rows, widths(f1, hidden, dims), calls) +
            2 * tower_bytes(rows, widths(f2, hidden, dims), calls))


def pair_flops(rows: int, f1: int, f2: int, hidden: Sequence[int],
               dims: int) -> int:
    """The towers of pushes over ``rows`` rows in all."""
    return (tower_flops(rows, widths(f1, hidden, dims)) +
            2 * tower_flops(rows, widths(f2, hidden, dims)))
