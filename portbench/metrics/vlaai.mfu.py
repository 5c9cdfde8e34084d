"""A VLAAI serving window's least model operations over its time, as a
share (%) of the card's float32 peak: every emitted row's multiply-adds
through the network (harness/flops_vlaai.py), as vlaai.model_roofline
counts them, over the window's host time."""

from portbench.harness import common, flops_vlaai


def read(readings):
    if readings.get('model') != 'vlaai' or not readings['pushes']:
        return None
    ops = readings['rows'] * flops_vlaai.row_flops(readings['config'])
    return 100.0 * ops / readings['window_s'] / common.FP32_FLOPS
