"""Mean host ms a sweep in the program's ``sweep.readback`` span: the
[lambda, file] grid read back to the host, the wait for the grid's last
kernels included."""

from portbench.harness import spans


def read(readings):
    return spans.per_sweep(readings, 'sweep.readback')
