"""The pushes' model operations over the window's time, as a share (%)
of the card's float32 peak: the decode of every frame through both
rotations with the correlation and LDA, the window means, and for the
state-space rule one update a window (harness/flops.py)."""

from portbench.harness import common, flops


def read(readings):
    if readings.get('kind') != 'serve' or not readings['pushes']:
        return None
    ops = flops.serve_push_flops(
        readings['rows'], readings['windows'], readings['width'],
        readings['f1'], readings['f2'], readings['dims'],
        readings['ssd_k_w'])
    return 100.0 * ops / readings['window_s'] / common.FP32_FLOPS
