"""Mean host ms a push in the program's ``serve.store`` span less the
decision rule's ``decide.window`` inside it: the scores into the window
store, the window iteration and the window means."""

from portbench.harness import spans


def read(readings):
    return spans.per_push(readings, 'serve.store', own=True)
