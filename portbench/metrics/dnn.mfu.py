"""A DNN serving window's model operations over its time, as a share (%)
of the card's float32 peak: the prediction once a push, both talkers'
correlations and the LDA of every frame (harness/flops_dnn.py) and the
window means."""

from portbench.harness import common, flops_dnn


def read(readings):
    if readings.get('model') != 'dnn' or not readings['pushes']:
        return None
    ops = (flops_dnn.push_flops(readings['rows'], readings['sizes']) +
           readings['windows'] * 2 * readings['width'])
    return 100.0 * ops / readings['window_s'] / common.FP32_FLOPS
