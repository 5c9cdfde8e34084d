"""The regression composition's share of its roofline, in %: the least
time of a push's prediction, correlations and LDA (bytes at the HBM rate
or float32 operations at the CUDA-core rate, whichever is larger;
harness/flops_dnn.py) over their device time a push
(dnn.regression_device_ms)."""

from portbench.harness import common, flops_dnn, serve_dnn


def read(readings):
    found = serve_dnn.regression_device(readings)
    calls = readings.get('infer_calls')
    if found is None or not calls or not found[0]:
        return None
    least, _ = common.bound(
        flops_dnn.push_bytes(readings['rows'], readings['sizes'],
                             calls=calls),
        flops_dnn.push_flops(readings['rows'], readings['sizes']))
    seconds, pushes = found
    return 100.0 * (least / calls) / (seconds / pushes)
