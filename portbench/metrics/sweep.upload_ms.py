"""Mean host ms a sweep in the program's ``sweep.upload`` spans: the
host stacks of the raw files and their masks built and copied to the
card."""

from portbench.harness import spans


def read(readings):
    return spans.per_sweep(readings, 'sweep.upload')
