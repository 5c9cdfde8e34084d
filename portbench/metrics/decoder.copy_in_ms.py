"""Mean host ms a push in the program's ``decoder.copy_in`` span: the
decoder's blocking copies of the chunk's three inputs from pageable host
memory to the card."""

from portbench.harness import spans


def read(readings):
    return spans.per_push(readings, 'decoder.copy_in')
