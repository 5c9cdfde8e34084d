"""Mean host ms a push in the program's ``serve.context`` span: the
chunk through StreamingAttentionServer's context buffers and queues and
the slicing to the rows every stream completed."""

from portbench.harness import spans


def read(readings):
    return spans.per_push(readings, 'serve.context')
