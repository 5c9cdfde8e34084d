"""VLAAI's share of its roofline, in %: the least time of a push's
predictions (its rows' multiply-adds at the float32 peak, or the
weights read once at the HBM rate, whichever is larger;
harness/flops_vlaai.py) over the device time a push
(vlaai.push_device_ms). The least work is fixed by the rows a push
emits, not by the frames an implementation recomputes."""

from portbench.harness import flops_vlaai, serve_vlaai


def read(readings):
    found = serve_vlaai.push_device(readings)
    calls = readings.get('infer_calls')
    if found is None or not calls or not found[0]:
        return None
    least = flops_vlaai.least_push_s(readings['config'], readings['rows'],
                                     calls)
    seconds, pushes = found
    return 100.0 * (least / calls) / (seconds / pushes)
