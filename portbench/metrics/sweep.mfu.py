"""The sweeps' operations by the plain algorithm (harness/flops.py:
moments, and per fit the factorisations and solves) over the window's
time, as a share (%) of the card's float32 peak (TF32 off, as the port
runs)."""

from portbench.harness import common, flops


def read(readings):
    if readings.get('kind') != 'sweep' or not readings['sweeps']:
        return None
    ops = readings['sweeps'] * flops.sweep_flops(
        readings['model'], readings['files'], readings['frames'],
        readings['x_channels'] * readings['x_lags'],
        readings['y_channels'] * readings['y_lags'], readings['lambdas'])
    return 100.0 * ops / readings['window_s'] / common.FP32_FLOPS
