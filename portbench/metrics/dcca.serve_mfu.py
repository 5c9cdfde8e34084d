"""A deep CCA serving window's model operations over its time, as a
share (%) of the card's float32 peak: the towers of every frame
(harness/flops_dcca.py), K1's decode of their outputs (F1 = F2 = D) and
the window means (harness/flops.py)."""

from portbench.harness import common, flops, flops_dcca


def read(readings):
    if readings.get('model') != 'dcca' or not readings['pushes']:
        return None
    dims = readings['dims']
    ops = (flops_dcca.pair_flops(readings['rows'], readings['f1'],
                                 readings['f2'], readings['hidden'], dims) +
           flops.serve_push_flops(readings['rows'], readings['windows'],
                                  readings['width'], dims, dims, dims))
    return 100.0 * ops / readings['window_s'] / common.FP32_FLOPS
