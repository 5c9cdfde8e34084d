"""Builds and loads the port's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface. At first use they
are compiled with ``nvcc`` for ``sm_90a``, one compiler process per
source started together, and linked into one shared library under
``build/telluride_kernels/`` at the root of the checkout, named by a hash
of the sources and flags (so an edit rebuilds and an unchanged tree
reuses the library), and loaded with ``ctypes``. Importing this module
builds nothing: the CPU tests import every module of the port.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception and counts a launch that succeeded in :data:`launches`, under
the kernel's name. A kernel that cannot be built, loaded or launched
raises :class:`KernelError`.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = _PACKAGE_DIR / 'csrc'
BUILD_DIR = _PACKAGE_DIR.parent / 'build' / 'telluride_kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
LINK_FLAGS = ('-shared', '-gencode', 'arch=compute_90a,code=sm_90a')

_VOID_P = ctypes.c_void_p
_INT = ctypes.c_int
_lib: Optional[ctypes.CDLL] = None
# Launches that succeeded, by the name each wrapper gives check().
launches: collections.Counter = collections.Counter()


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch."""


def _sources():
    return sorted(CSRC_DIR.glob('*.cu'))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256(' '.join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / ('libtelluride_kernels_%s.so' % digest.hexdigest()[:16])


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise KernelError('nvcc not found (PATH or /usr/local/cuda/bin): the '
                      'CUDA kernels cannot be built.')


def build() -> Path:
    """Compiles the kernels unless the library for these sources exists.

    One ``nvcc -c`` per source, all started together, then one link.
    The compilers' output, including the ptxas register and shared
    memory report, goes to ``build.log`` beside the library."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        jobs = []
        for src in _sources():
            obj = os.path.join(work, src.stem + '.o')
            cmd = [nvcc, *NVCC_FLAGS, '-c', str(src), '-o', obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for cmd, _, proc in jobs:
            output, _ = proc.communicate()
            log.append((cmd, proc.returncode, output))
        if all(rc == 0 for _, rc, _ in log):
            tmp = os.path.join(work, 'lib.so')
            cmd = [nvcc, *LINK_FLAGS, '-o', tmp] + [obj for _, obj, _ in jobs]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            log.append((cmd, proc.returncode, proc.stdout))
        (BUILD_DIR / 'build.log').write_text(''.join(
            ' '.join(cmd) + '\n' + output for cmd, _, output in log))
        failed = [(cmd, rc, output) for cmd, rc, output in log if rc != 0]
        if failed:
            cmd, rc, output = failed[0]
            raise KernelError('nvcc failed (rc %d): %s\n%s'
                              % (rc, ' '.join(cmd), output[-4000:]))
        # Atomic: a concurrent build sees either no library or a whole one.
        os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as error:
            raise KernelError('cannot load %s: %s' % (path, error)) from error
        lib.tdt_lag_stack_f32.argtypes = [_VOID_P, _VOID_P, _INT, _INT,
                                          _INT, _INT, _VOID_P]
        lib.tdt_lag_stack_f32.restype = _INT
        lib.tdt_fused_cca_decode.argtypes = [_VOID_P] * 10
        lib.tdt_fused_cca_decode.restype = _INT
        lib.tdt_fused_cca_decode_bf16.argtypes = (
            [_VOID_P] * 8 + [_INT] * 7 + [_VOID_P])
        lib.tdt_fused_cca_decode_bf16.restype = _INT
        lib.tdt_fused_envelope_lagstack.argtypes = (
            [_VOID_P] * 4 + [_INT] * 4 + [ctypes.c_float, _VOID_P])
        lib.tdt_fused_envelope_lagstack.restype = _INT
        lib.tdt_ssd_update.argtypes = [_VOID_P] * 6 + [_INT] * 5 + [_VOID_P]
        lib.tdt_ssd_update.restype = _INT
        lib.tdt_ssd_sequence.argtypes = [_VOID_P] * 6 + [_INT] * 6 + [_VOID_P]
        lib.tdt_ssd_sequence.restype = _INT
        lib.tdt_dcca_towers.argtypes = [_VOID_P] * 10
        lib.tdt_dcca_towers.restype = _INT
        lib.tdt_regression_push.argtypes = [_VOID_P] * 7
        lib.tdt_regression_push.restype = _INT
        lib.tdt_error_string.argtypes = [_INT]
        lib.tdt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raises if a C entry point reported a CUDA error, else counts one
    launch of ``what``."""
    if code != 0:
        message = library().tdt_error_string(code).decode()
        raise KernelError('%s: CUDA error %d (%s)' % (what, code, message))
    launches[what] += 1


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (a CUDA
    device with an index).

    torch._C._cuda_getCurrentRawStream (private; present in torch 2.x up
    to 2.11 at least) skips building a Stream object, a few microseconds
    a call. A torch without it takes the public current_stream.
    """
    import torch
    raw = getattr(torch._C, '_cuda_getCurrentRawStream', None)
    if raw is None:
        return torch.cuda.current_stream(device).cuda_stream
    return raw(device.index)
