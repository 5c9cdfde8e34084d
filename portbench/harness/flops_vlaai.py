"""The minimal work of VLAAI's predictions, from the configuration's
widths alone: the multiply-adds of one output frame through every
convolution, dense layer and the output layer (a multiply-add is two
operations; layer norms, leaky ReLUs, bias adds and the skip's adds are
not counted, nor the correlations and the LDA after the prediction), and
the bytes of the weights, each read once.

The work a push is fixed by the rows it emits, not by what an
implementation recomputes: a forward pass over a raw window of rows +
264 frames does about 9.25 times the work of 32 rows, and a later one
that keeps each layer's state between pushes reads the same minimal
work. At the published widths a row is 6,848,576 multiply-adds (13.70
MFLOP) and the weights 1,740,289 floats (6.96 MB).
"""

from __future__ import annotations

from portbench.harness.common import bound

F32 = 4


def _convolutions(cfg: dict):
    """(kernel, inputs, outputs) of every convolution a block runs: the
    extractor's layers, then the output context's."""
    c = cfg['eeg_channels']
    widths = [c] + list(cfg['extractor_filters'])
    layers = [(k, i, o) for k, i, o in zip(cfg['extractor_kernels'],
                                           widths[:-1], widths[1:])]
    return layers + [(cfg['context_kernel'], c, cfg['context_filters'])]


def row_flops(cfg: dict) -> int:
    """Operations of one output frame: every block's convolutions and
    dense layer, then the output layer."""
    macs = sum(k * i * o for k, i, o in _convolutions(cfg))
    macs += cfg['extractor_filters'][-1] * cfg['dense_units']
    macs = cfg['blocks'] * macs + cfg['context_filters'] * cfg['output_width']
    return 2 * macs


def parameters(cfg: dict) -> int:
    """Floats of the weights: the shared extractor and output context
    (each convolution's kernel and bias, each layer norm's scale and
    shift), a dense layer a block, the output layer."""
    shared = sum(k * i * o + 3 * o for k, i, o in _convolutions(cfg))
    dense = cfg['extractor_filters'][-1] * cfg['dense_units'] + \
        cfg['dense_units']
    out = cfg['context_filters'] * cfg['output_width'] + cfg['output_width']
    return shared + cfg['blocks'] * dense + out


def weight_bytes(cfg: dict) -> int:
    return F32 * parameters(cfg)


def least_push_s(cfg: dict, rows: int, calls: int = 1) -> float:
    """The least time of ``calls`` pushes over ``rows`` rows in all: the
    larger of their operations at the float32 peak and the weights read
    once a push at the HBM rate."""
    seconds, _ = bound(calls * weight_bytes(cfg), rows * row_flops(cfg))
    return seconds
