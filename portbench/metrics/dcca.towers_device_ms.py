"""Device ms a push of the traced slice's kernels that are neither K1
(``fused_cca_decode_cluster_kernel``) nor a copy or a fill: in a deep
CCA serving cell, the towers' products, bias adds and ReLUs. Pushes are
counted by K1's launches in the same trace, one a push."""

from portbench.harness import serve_dcca


def read(readings):
    found = serve_dcca.towers_device(readings)
    return None if found is None else found[0] / found[1] * 1e3
