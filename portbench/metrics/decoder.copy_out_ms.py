"""Mean host ms a push in the program's ``decoder.copy_out`` spans: the
two reads of the scores back to the host, the wait on K1 included."""

from portbench.harness import spans


def read(readings):
    return spans.per_push(readings, 'decoder.copy_out')
