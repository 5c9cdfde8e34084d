"""Device ms a push of the traced slice's kernels that are neither a copy
nor a fill (``Memcpy``, ``Memset``): in a VLAAI serving cell, the
network's unfolds, products, layer norms, activations and pads, then the
correlations and the LDA. Pushes are counted by a kernel launched once a
push in the same trace (harness/serve_vlaai.py's ``PUSH_KERNEL``, the
stack of the two talkers' scores)."""

from portbench.harness import serve_vlaai


def read(readings):
    found = serve_vlaai.push_device(readings)
    return None if found is None else found[0] / found[1] * 1e3
