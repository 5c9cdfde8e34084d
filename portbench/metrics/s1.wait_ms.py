"""Mean host ms a window in the program's ``s1.wait`` span: the
state-space rule's event record, wait on S1 and read of the decision,
over the traced slice's ``decide.window`` spans."""

from portbench.harness import spans


def read(readings):
    found = spans.read(readings, 'serve')
    if found is None or not found.count('s1.wait'):
        return None
    return found.ms('s1.wait', found.count('decide.window'))
