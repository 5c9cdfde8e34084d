"""K1's share of its roofline, in %: the least time of the window's
served calls (bytes at the HBM rate or float32 operations at the
CUDA-core rate, whichever is larger) over the profiler's device time of
``fused_cca_decode_cluster_kernel``."""

from portbench.harness import common, flops, trace


def read(readings):
    if readings.get('kind') != 'serve':
        return None
    seen = trace.kernel(readings, 'fused_cca_decode_cluster_kernel')
    calls = readings['infer_calls']
    if seen is None or not calls:
        return None
    seconds, launches = seen
    shape = (readings['f1'], readings['f2'], readings['dims'])
    least, _ = common.bound(
        flops.k1_bytes(readings['rows'], *shape, calls=calls),
        flops.k1_flops(readings['rows'], *shape))
    # Per launch, in case the trace missed launches of the window.
    return 100.0 * (least / calls) / (seconds / launches)
