"""K2's share of its roofline, in %: a launch's raw rows read and
stacked rows written at the HBM rate, over the profiler's device time of
``lag_stack_kernel`` a launch. Each sweep stacks every file's EEG, and
its intensity where the mix lags it."""

from portbench.harness import common, flops, trace


def read(readings):
    seen = trace.kernel(readings, 'lag_stack_kernel')
    if readings.get('kind') != 'sweep' or seen is None:
        return None
    seconds, launches = seen
    rows = readings['raw_rows']
    per_file = [flops.k2_bytes(rows, readings['x_channels'],
                               readings['x_lags'])]
    if readings['y_lags'] > 1:
        per_file.append(flops.k2_bytes(rows, readings['y_channels'],
                                       readings['y_lags']))
    least = sum(common.bound(b, 0)[0] for b in per_file) / len(per_file)
    return 100.0 * least / (seconds / launches)
