"""Mean host ms a push in the program's ``decoder.launch`` span: the
pipeline check, then K1's checks, launch plan and launch."""

from portbench.harness import spans


def read(readings):
    return spans.per_push(readings, 'decoder.launch')
