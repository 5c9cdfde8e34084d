"""Operations and bytes of a regression decoder's composition of a push
(the fullyconnected DNN regressor's prediction, then each talker's
correlation with it and the scaled LDA), from shapes alone, by the plain
algorithm (as harness/flops.py counts the rest): the prediction once a
push, each weight and bias read once, the input rows read once and each
layer's output written once (harness/flops_dcca.py's tower); for each
talker its envelope and the prediction read and one score a frame
written. A multiply-add is two operations, a bias add, a ReLU, a
subtraction, a product and a division one each."""

from __future__ import annotations

from typing import Sequence

from portbench.harness.flops_dcca import F32, tower_bytes, tower_flops

TALKERS = 2


def correlate_flops(rows: int, out: int) -> int:
    """One talker over ``rows`` frames: (y - cmx)(pred - cmy) / p an
    output, the LDA's sum over the outputs, its slope and intercept."""
    return rows * (4 * out + 2 * out + 2)


def push_bytes(rows: int, sizes: Sequence[int], calls: int = 1) -> int:
    """``calls`` pushes over ``rows`` rows in all, layer widths ``sizes``
    (input first, the output width last)."""
    out = sizes[-1]
    return (tower_bytes(rows, sizes, calls) +
            F32 * TALKERS * rows * (2 * out + 1))


def push_flops(rows: int, sizes: Sequence[int]) -> int:
    """The composition of pushes over ``rows`` rows in all."""
    return (tower_flops(rows, sizes) +
            TALKERS * correlate_flops(rows, sizes[-1]))
