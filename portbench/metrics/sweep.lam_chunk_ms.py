"""Mean host ms of one ``sweep.lam_chunk`` span: one batch of lambdas'
factorisations and solves dispatched, with any host read inside (the
CCA grid's SVD reads back to the host twice)."""

from portbench.harness import spans


def read(readings):
    found = spans.read(readings, 'sweep')
    if found is None:
        return None
    return found.ms('sweep.lam_chunk', found.count('sweep.lam_chunk'))
