"""The native TFRecord codec, built with g++ and loaded with ctypes.

Port of telluride_decoding_tpu/_native/__init__.py. ``tdt_records.cc``
is a copy of the JAX package's source. At first use it is compiled with
``g++ -O3 -shared -fPIC -std=c++17`` into ``build/tdt_records/`` at the
root of the checkout, named by a hash of the source and flags, and the
file is put in place atomically (a concurrent build sees either no
library or a whole one). Unlike the JAX loader there is no silent
fallback to pure Python: if the library cannot be built or loaded,
:func:`lib` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / 'tdt_records.cc'
BUILD_DIR = SOURCE.parents[2] / 'build' / 'tdt_records'
GXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    digest = hashlib.sha256(' '.join(GXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / ('libtdt_records_%s.so' % digest.hexdigest()[:16])


def build() -> Path:
    """Compiles the codec unless the library for this source exists."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(['g++', *GXX_FLAGS, str(SOURCE), '-o', tmp],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError('g++ failed to build %s (rc %d):\n%s'
                               % (SOURCE, proc.returncode,
                                  proc.stdout[-4000:]))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.tdt_crc32c.restype = ctypes.c_uint32
    lib.tdt_crc32c.argtypes = [u8p, i64]
    lib.tdt_masked_crc32c.restype = ctypes.c_uint32
    lib.tdt_masked_crc32c.argtypes = [u8p, i64]
    lib.tdt_scan_records.restype = i64
    lib.tdt_scan_records.argtypes = [u8p, i64, ctypes.c_int, i64p, i64p,
                                     i64]
    lib.tdt_read_feature.restype = i64
    lib.tdt_read_feature.argtypes = [u8p, i64p, i64p, i64,
                                     ctypes.c_char_p, f32p, i64]
    lib.tdt_validate_examples.restype = i64
    lib.tdt_validate_examples.argtypes = [u8p, i64p, i64p, i64, i64p,
                                          i64p]
    lib.tdt_encoded_size.restype = i64
    lib.tdt_encoded_size.argtypes = [i64p, i64p, i64, i64]
    lib.tdt_encode_file.restype = i64
    lib.tdt_encode_file.argtypes = [ctypes.c_char_p, i64p, i64p,
                                    ctypes.POINTER(f32p), i64, i64, u8p,
                                    i64]
    return lib


def lib() -> ctypes.CDLL:
    """The native library, built and loaded on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _configure(ctypes.CDLL(str(build())))
        return _LIB
