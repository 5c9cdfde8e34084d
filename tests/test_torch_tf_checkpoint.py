"""TensorBundle reader and writer of the PyTorch port vs the JAX package.

The same bytes go through both packages' snappy decoder and bundle
reader, and the same arrays through both writers: the writers must give
identical ``.index`` and ``.data-00000-of-00001`` files, each package
must read what the other wrote, and on garbage, mutants and snappy
blocks the port must give the JAX reader's outcome (the same exception
class, or the same dict of arrays). Snappy-compressed index blocks come
from tools/snappy_blocks.py, since neither writer compresses. The
reader's copied reference behaviours (ROADMAP §3) are pinned on both
sides.
"""

import os
import shutil
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from test_fuzz_codecs import N_MUTANTS, _garbage_blobs, _mutate  # noqa: E402
from tools import snappy_blocks  # noqa: E402

from telluride_decoding_tpu.io import tf_checkpoint as jax_ckpt  # noqa: E402
from telluride_decoding_torch.data.records import masked_crc32c  # noqa: E402
from telluride_decoding_torch.io import tf_checkpoint  # noqa: E402

PACKAGES = {'jax': jax_ckpt, 'torch': tf_checkpoint}
DATA = '.data-00000-of-00001'


def outcome(fn, *args):
    """('raised', exception class name) or ('returned', value). The
    packages' CorruptRecordError classes are two classes of one name."""
    try:
        return 'returned', fn(*args)
    except Exception as error:  # noqa: BLE001 - the property under test
        return 'raised', type(error).__name__


def assert_same_tensors(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert got[key].shape == value.shape, key
        if value.dtype == object:
            assert list(got[key].reshape(-1)) == list(value.reshape(-1))
        else:
            np.testing.assert_array_equal(got[key], value)


def assert_same_outcome(got, want):
    assert got[0] == want[0], (got, want)
    if got[0] == 'raised':
        assert got[1] == want[1]
    elif isinstance(want[1], dict):
        assert_same_tensors(got[1], want[1])
    else:
        assert got[1] == want[1]


def read_both(prefix):
    got = outcome(tf_checkpoint.read_tensor_bundle, prefix)
    assert_same_outcome(got, outcome(jax_ckpt.read_tensor_bundle, prefix))
    return got


def files(prefix):
    with open(prefix + '.index', 'rb') as f:
        index = f.read()
    with open(prefix + DATA, 'rb') as f:
        return index, f.read()


# -- snappy -------------------------------------------------------------------

STREAMS = {
    # tests/test_migrate.py's hand-built streams.
    'literal': bytes([5, (4 << 2) | 0]) + b'hello',
    'back_reference': bytes([4, (1 << 2) | 0]) + b'ab' +
                      bytes([(1 << 2) | 2, 2, 0]),
    'overlapping_copy': bytes([5, 0]) + b'a' + bytes([(3 << 2) | 2, 1, 0]),
    # A copy of each offset size: 8 literal bytes, then 8 bytes from 8
    # back (1-byte offset: length 4-11 in the tag, offset's high bits).
    'copy_1_byte_offset': bytes([16, 7 << 2]) + b'abcdefgh' +
                          bytes([(4 << 2) | 1, 8]),
    'copy_2_byte_offset': bytes([16, 7 << 2]) + b'abcdefgh' +
                          bytes([(7 << 2) | 2, 8, 0]),
    'copy_4_byte_offset': bytes([16, 7 << 2]) + b'abcdefgh' +
                          bytes([(7 << 2) | 3, 8, 0, 0, 0]),
    # Literals with their length in one and in two extra bytes, and a
    # 1-byte-offset copy whose offset needs the tag's high bits (300 =
    # 1 << 8 | 44).
    'long_literals_far_copy': bytes([0xB0, 0x02, 60 << 2, 99]) +
                              bytes(range(100)) +
                              bytes([61 << 2, 199, 0]) +
                              bytes(range(100, 256)) + bytes(range(44)) +
                              bytes([(1 << 5) | 1, 44]),
    'bad_offset': bytes([8, 0]) + b'a' + bytes([(6 << 2) | 2, 9, 0]),
    'zero_offset': bytes([8, 0]) + b'a' + bytes([(6 << 2) | 2, 0, 0]),
    'size_mismatch': bytes([9, (4 << 2) | 0]) + b'hello',
    'truncated_varint': bytes([0x80]),
}
WANT = {'literal': b'hello', 'back_reference': b'abab',
        'overlapping_copy': b'aaaaa',
        'copy_1_byte_offset': b'abcdefgh' * 2,
        'copy_2_byte_offset': b'abcdefgh' * 2,
        'copy_4_byte_offset': b'abcdefgh' * 2,
        'long_literals_far_copy': bytes(range(256)) + bytes(range(44)) +
                                  bytes(range(4))}


@pytest.mark.parametrize('name', sorted(STREAMS))
def test_snappy_streams_match_jax(name):
    got = outcome(tf_checkpoint.snappy_decompress, STREAMS[name])
    assert_same_outcome(got, outcome(jax_ckpt.snappy_decompress,
                                     STREAMS[name]))
    if name in WANT:
        assert got == ('returned', WANT[name])
    else:
        assert got[0] == 'raised'


@settings(max_examples=300, database=None, deadline=None)
@given(st.binary(max_size=200))
def test_snappy_random_bytes_match_jax(data):
    assert_same_outcome(outcome(tf_checkpoint.snappy_decompress, data),
                        outcome(jax_ckpt.snappy_decompress, data))


@pytest.mark.parametrize('kind', [None, 1, 2, 4])
def test_snappy_encoder_round_trips_in_both(kind):
    """The test encoder's streams (every copy of one offset size, or the
    smallest) decode to the input in both packages."""
    rng = np.random.RandomState(3)
    data = (rng.randint(0, 4, size=3000).astype(np.uint8).tobytes() +
            b'abcabcabc' * 40 + rng.bytes(70000) + b'abcabcabc')
    packed = snappy_blocks.snappy_compress(data, kind)
    assert tf_checkpoint.snappy_decompress(packed) == data
    assert jax_ckpt.snappy_decompress(packed) == data


# -- the writer ---------------------------------------------------------------

def tensor_cases():
    rng = np.random.RandomState(7)
    return {
        'float32': {'a/f32': rng.randn(5, 3).astype(np.float32)},
        'float64': {'b/f64': rng.randn(4)},
        'int32': {'c/i32': np.arange(6, dtype=np.int32).reshape(2, 3)},
        'int64': {'d/i64': np.arange(3, dtype=np.int64) - 2 ** 40},
        'bool': {'e/bool': np.array([True, False, True])},
        'string': {'f/str': np.array([b'hello', b'', b'w' * 300],
                                     dtype=object)},
        'str_kinds': {'g/u': np.array(['x', 'yz']),
                      'g/s': np.array([b'p', b'qr'])},
        'scalar': {'h/scalar': np.float32(3.5).reshape(()),
                   'h/string': np.array(b'{"k": 1}', dtype=object)},
        'empty': {'i/empty': np.zeros((0, 4), np.float32),
                  'i/empty_str': np.array([], dtype=object)},
        'small_ints': {'j/u8': np.arange(4, dtype=np.uint8),
                       'j/i16': np.arange(4, dtype=np.int16),
                       'j/u64': np.arange(4, dtype=np.uint64)},
        'object_graph': {
            '_CHECKPOINTABLE_OBJECT_GRAPH': np.array(b'\x0a\x02\x08\x01',
                                                     dtype=object),
            'variables/0/.ATTRIBUTES/VARIABLE_VALUE':
                rng.randn(2, 2).astype(np.float32)},
        'many': {'layer_%03d/kernel' % i: rng.randn(i % 3 + 1, 2)
                 for i in range(40)},
    }


CASES = sorted(tensor_cases())


@pytest.mark.parametrize('case', CASES)
def test_writer_bytes_match_jax(case, tmp_path):
    tensors = tensor_cases()[case]
    tf_checkpoint.write_tensor_bundle(str(tmp_path / 'torch'), tensors)
    jax_ckpt.write_tensor_bundle(str(tmp_path / 'jax'), tensors)
    assert files(str(tmp_path / 'torch')) == files(str(tmp_path / 'jax'))


@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('writer', sorted(PACKAGES))
def test_cross_reads(case, writer, tmp_path):
    """What one package writes, the other reads: equal arrays and dtypes
    (the object graph is skipped by both)."""
    prefix = str(tmp_path / 'variables')
    PACKAGES[writer].write_tensor_bundle(prefix, tensor_cases()[case])
    got = read_both(prefix)
    assert got[0] == 'returned'
    assert not any(k.startswith('_CHECKPOINTABLE') for k in got[1])


def test_writer_refuses_what_jax_refuses(tmp_path):
    for tensors in ({'c': np.array([1 + 2j])},
                    {'t': np.array(['2020-01-01'], dtype='datetime64[D]')}):
        got = outcome(tf_checkpoint.write_tensor_bundle,
                      str(tmp_path / 't'), tensors)
        assert_same_outcome(got, outcome(jax_ckpt.write_tensor_bundle,
                                         str(tmp_path / 'j'), tensors))
        assert got == ('raised', 'TypeError')


# -- snappy index blocks --------------------------------------------------------

@pytest.mark.parametrize('kind', [None, 1, 2, 4])
@pytest.mark.parametrize('case', ['many', 'scalar', 'string'])
def test_snappy_block_bundles_read_alike(case, kind, tmp_path):
    """An index whose data, metaindex and index blocks are snappy (type 1,
    masked crc recomputed) reads as the uncompressed one in both."""
    plain = str(tmp_path / 'plain')
    tensors = tensor_cases()[case]
    tf_checkpoint.write_tensor_bundle(plain, tensors)
    packed = str(tmp_path / 'packed')
    assert snappy_blocks.snappy_index(plain + '.index', packed + '.index',
                                      masked_crc32c, kind) == 3
    shutil.copyfile(plain + DATA, packed + DATA)
    with open(packed + '.index', 'rb') as f:
        assert f.read() != files(plain)[0]
    got = read_both(packed)
    assert got[0] == 'returned'
    assert_same_tensors(got[1], tf_checkpoint.read_tensor_bundle(plain))


def test_unknown_block_compression_raises_alike(tmp_path):
    prefix = str(tmp_path / 'v')
    tf_checkpoint.write_tensor_bundle(prefix, tensor_cases()['float32'])
    index, _ = files(prefix)
    # The last block before the footer is the index block; its type byte
    # sits 5 bytes before the footer.
    at = len(index) - 48 - 5
    assert index[at] == 0
    with open(prefix + '.index', 'wb') as f:
        f.write(index[:at] + b'\x02' + index[at + 1:])
    assert read_both(prefix) == ('raised', 'ValueError')


# -- fuzz parity (the loops of tests/test_fuzz_codecs.py) -----------------------

def fuzz_bundle(prefix):
    """tests/test_fuzz_codecs.py's valid bundle."""
    rng = np.random.RandomState(0)
    jax_ckpt.write_tensor_bundle(prefix, {
        'model/layer/kernel/.ATTRIBUTES/VARIABLE_VALUE':
            rng.randn(4, 3).astype(np.float32),
        'model/layer/bias/.ATTRIBUTES/VARIABLE_VALUE': rng.randn(3),
        'telluride_metadata/.ATTRIBUTES/VARIABLE_VALUE':
            np.array([b'{"dnn_regressor": "linear"}'], dtype=object),
    })
    return files(prefix)


def test_garbage_index_matches_jax(tmp_path):
    rng = np.random.RandomState(9)
    prefix = str(tmp_path / 'g')
    for blob in _garbage_blobs(rng):
        with open(prefix + '.index', 'wb') as f:
            f.write(blob)
        with open(prefix + DATA, 'wb') as f:
            f.write(blob)
        read_both(prefix)


def test_mutated_valid_matches_jax(tmp_path):
    index, data = fuzz_bundle(str(tmp_path / 'valid'))
    rng = np.random.RandomState(10)
    prefix = str(tmp_path / 'mut')
    outcomes = set()
    for i in range(N_MUTANTS):
        with open(prefix + '.index', 'wb') as f:
            f.write(_mutate(rng, index) if i % 2 == 0 else index)
        with open(prefix + DATA, 'wb') as f:
            f.write(data if i % 2 == 0 else _mutate(rng, data))
        got = read_both(prefix)
        outcomes.add(got[0] if got[0] == 'returned' else got[1])
    assert 'returned' in outcomes and len(outcomes) > 1, outcomes


# -- reference behaviours the port copies (ROADMAP §3), on both sides ----------

def retype(prefix, name, code):
    """Rewrites the dtype of tensor ``name`` in place (its BundleEntry
    starts with field 1 as ``08 01``), leaving the block's crc stale."""
    index, _ = files(prefix)
    key = name.encode() + b'\x08\x01'
    assert index.count(key) == 1
    with open(prefix + '.index', 'wb') as f:
        f.write(index.replace(key, name.encode() + b'\x08' + bytes([code])))


@pytest.mark.parametrize('code', [19, 14])   # DT_HALF, DT_BFLOAT16.
@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_unknown_dtype_is_skipped_without_a_word(package, code, tmp_path):
    prefix = str(tmp_path / 'v')
    tf_checkpoint.write_tensor_bundle(prefix, {
        'half': np.ones(4, np.float32), 'kept': np.arange(3.0)})
    retype(prefix, 'half', code)
    got = PACKAGES[package].read_tensor_bundle(prefix)
    assert sorted(got) == ['kept']


@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_no_checksum_is_verified_on_read(package, tmp_path):
    """A flipped data byte and a stale block crc read back as they are."""
    prefix = str(tmp_path / 'v')
    tf_checkpoint.write_tensor_bundle(prefix, {
        'x': np.zeros(4, np.float32)})
    index, data = files(prefix)
    with open(prefix + DATA, 'wb') as f:
        f.write(b'\x01' + data[1:])
    at = len(index) - 48 - 4              # The index block's crc.
    with open(prefix + '.index', 'wb') as f:
        f.write(index[:at] + bytes(4) + index[at + 4:])
    got = PACKAGES[package].read_tensor_bundle(prefix)
    assert got['x'].view(np.uint32)[0] == 1


@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_reads_shard_zero_by_glob(package, tmp_path):
    """A bundle written as one shard reads shard 0 by name, and falls
    back to any ``data-00000-of-*`` file; with none it raises."""
    prefix = str(tmp_path / 'v')
    tf_checkpoint.write_tensor_bundle(prefix, {'x': np.arange(4.0)})
    os.rename(prefix + DATA, prefix + '.data-00000-of-00003')
    got = PACKAGES[package].read_tensor_bundle(prefix)
    np.testing.assert_array_equal(got['x'], np.arange(4.0))
    os.remove(prefix + '.data-00000-of-00003')
    with pytest.raises(FileNotFoundError):
        PACKAGES[package].read_tensor_bundle(prefix)
