"""Device ms a push of the traced slice's kernels that are neither K2
(``lag_stack_kernel``) nor a copy or a fill: in a DNN serving cell, the
prediction's products, bias adds and ReLUs, the correlations and the
LDA. Pushes are counted by K2's launches in the same trace, one a push
(the EEG's lag stack; the audio takes no context)."""

from portbench.harness import serve_dnn


def read(readings):
    found = serve_dnn.regression_device(readings)
    return None if found is None else found[0] / found[1] * 1e3
