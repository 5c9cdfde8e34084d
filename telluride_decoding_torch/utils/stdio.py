"""Late-binding stdout for embeddable CLI drivers (copy of
utils/stdio.py).

The reference's drivers print driver-level results to a module-global
stream (e.g. reference regression.py:70 ``regression_print``). Binding
``sys.stdout`` at import time breaks repeated embedded calls when the
surrounding harness swaps or closes the stream between calls (pytest
capsys, notebook kernels), so this proxy resolves ``sys.stdout`` per
write instead.
"""
import sys


class LateBoundStdout:
    """File-like object that forwards to the CURRENT sys.stdout."""

    def write(self, s):
        return sys.stdout.write(s)

    def flush(self):
        sys.stdout.flush()
