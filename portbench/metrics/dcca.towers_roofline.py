"""The towers' share of their roofline, in %: the least time of a push's
three tower passes (bytes at the HBM rate or float32 operations at the
CUDA-core rate, whichever is larger; harness/flops_dcca.py) over their
device time a push (dcca.towers_device_ms)."""

from portbench.harness import common, flops_dcca, serve_dcca


def read(readings):
    found = serve_dcca.towers_device(readings)
    calls = readings.get('infer_calls')
    if found is None or not calls or not found[0]:
        return None
    shape = (readings['f1'], readings['f2'], readings['hidden'],
             readings['dims'])
    least, _ = common.bound(
        flops_dcca.pair_bytes(readings['rows'], *shape, calls=calls),
        flops_dcca.pair_flops(readings['rows'], *shape))
    seconds, pushes = found
    return 100.0 * (least / calls) / (seconds / pushes)
