"""TFRecord codec of the PyTorch port vs the JAX package.

Both packages write the same frame-per-record tf.train.Example files:
a file written by either is byte-identical to the other's and reads in
both. The port's native library is built here with g++.
"""

import os

import numpy as np
import pytest

from telluride_decoding_tpu.data import records as jax_records
from telluride_decoding_torch import _native
from telluride_decoding_torch.data import records


def _arrays(rng, n=300, dtype=np.float32):
    return {'eeg': rng.randn(n, 8).astype(np.float32),
            'intensity': rng.randn(n, 1).astype(np.float32),
            'attended_speaker': (rng.rand(n, 1) > 0.5).astype(dtype)}


@pytest.mark.parametrize('dtype', [np.float32, np.int64],
                         ids=['float_fields', 'int_fallback'])
def test_files_byte_identical_and_cross_read(rng, tmp_path, dtype):
    arrays = _arrays(rng, dtype=dtype)
    port_path = str(tmp_path / 'port.tfrecords')
    jax_path = str(tmp_path / 'jax.tfrecords')
    records.convert_data_to_tfrecords(arrays, port_path)
    jax_records.convert_data_to_tfrecords(arrays, jax_path)
    with open(port_path, 'rb') as f, open(jax_path, 'rb') as g:
        assert f.read() == g.read()
    for read in (records.read_tfrecords, jax_records.read_tfrecords):
        for path in (port_path, jax_path):
            got = read(path)
            assert set(got) == set(arrays)
            for k, v in arrays.items():
                np.testing.assert_array_equal(got[k], v)
    assert records.count_tfrecords(jax_path) == (300, False)
    assert jax_records.count_tfrecords(port_path) == (300, False)
    got = records.discover_feature_shapes(jax_path)
    want = jax_records.discover_feature_shapes(port_path)
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
        {k: (v.shape, v.dtype) for k, v in want.items()}


def test_corrupt_record_raises_in_both(rng, tmp_path):
    path = str(tmp_path / 'bad.tfrecords')
    records.convert_data_to_tfrecords(_arrays(rng, n=20), path)
    data = bytearray(open(path, 'rb').read())
    data[len(data) // 2] ^= 0xFF
    with open(path, 'wb') as f:
        f.write(bytes(data))
    for module in (records, jax_records):
        with pytest.raises(module.CorruptRecordError):
            list(module.iter_tfrecords(path, validate=True))
        count, error = module.count_tfrecords(path)
        assert error and count < 20


def test_crc32c_matches_jax():
    for data in (b'', b'a', b'123456789', bytes(range(256)) * 7):
        assert records.crc32c(data) == jax_records.crc32c(data)
    assert records.crc32c(b'123456789') == 0xE3069283   # CRC-32C check.


def test_native_library_builds_here():
    path = _native.build()
    assert path.exists() and path.parent == _native.BUILD_DIR
    assert path == _native.library_path()
    assert os.path.basename(str(path)).startswith('libtdt_records_')
    assert _native.lib().tdt_masked_crc32c is not None
