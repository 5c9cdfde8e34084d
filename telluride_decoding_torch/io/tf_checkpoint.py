"""TF-free reader and writer of TensorFlow checkpoints (TensorBundle).

Copy of telluride_decoding_tpu/io/tf_checkpoint.py for the port. A
Keras SavedModel keeps its weights in a TensorBundle: ``variables.index``
(a LevelDB-style SSTable mapping variable names to BundleEntry protos)
and ``variables.data-*`` shards of raw tensor bytes. The reader parses
snappy blocks, the SSTable's prefix-compressed blocks and the
BundleEntry wire format itself, with no TensorFlow; the writer emits
uncompressed table blocks with masked crc32c trailers, a BundleHeader,
BundleEntry protos and per-tensor checksums, byte for byte as the JAX
writer does.

Format references: leveldb table_format.md and
tensorflow/core/util/tensor_bundle.
"""

from __future__ import annotations

import glob
import os
import struct
from typing import Dict, List, Tuple

import numpy as np

from telluride_decoding_torch.data.records import (_read_varint,
                                                   _write_varint,
                                                   masked_crc32c)

_TABLE_MAGIC = 0xDB4775248B80FB57


def snappy_decompress(data: bytes) -> bytes:
    """Raw snappy decompression (format_description.txt)."""
    buf = memoryview(data)
    total, pos = _read_varint(buf, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                                # Literal.
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                length = int.from_bytes(buf[pos:pos + extra],
                                        'little') + 1
                pos += extra
            out.extend(buf[pos:pos + length])
            pos += length
            continue
        if kind == 1:                                # Copy, 1-byte offset.
            length = 4 + ((tag >> 2) & 7)
            offset = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:                              # Copy, 2-byte offset.
            length = (tag >> 2) + 1
            offset = int.from_bytes(buf[pos:pos + 2], 'little')
            pos += 2
        else:                                        # Copy, 4-byte offset.
            length = (tag >> 2) + 1
            offset = int.from_bytes(buf[pos:pos + 4], 'little')
            pos += 4
        if offset == 0 or offset > len(out):
            # offset > len(out) would wrap negative under Python
            # indexing and copy bytes from near the end of the output.
            raise ValueError('snappy: bad copy offset %d (have %d '
                             'bytes)' % (offset, len(out)))
        start = len(out) - offset
        if offset >= length:                         # No self-overlap.
            out += out[start:start + length]
        else:
            for i in range(length):                  # Self-overlapping
                out.append(out[start + i])           # run-length copy.
    if len(out) != total:
        raise ValueError('snappy: size mismatch (%d != %d)' %
                         (len(out), total))
    return bytes(out)


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """One SSTable block: payload + 1-byte type + 4-byte crc."""
    block = data[offset:offset + size]
    block_type = data[offset + size]
    if block_type == 1:
        return snappy_decompress(block)
    if block_type != 0:
        raise ValueError('Unsupported block compression %d' % block_type)
    return block


def _parse_block_entries(block: bytes) -> List[Tuple[bytes, bytes]]:
    """Prefix-compressed (key, value) entries of one block."""
    if len(block) < 4:
        return []
    num_restarts = struct.unpack_from('<I', block, len(block) - 4)[0]
    data_end = len(block) - 4 - 4 * num_restarts
    buf = memoryview(block)
    entries = []
    pos = 0
    key = b''
    while pos < data_end:
        shared, pos = _read_varint(buf, pos)
        non_shared, pos = _read_varint(buf, pos)
        value_len, pos = _read_varint(buf, pos)
        key = key[:shared] + bytes(buf[pos:pos + non_shared])
        pos += non_shared
        value = bytes(buf[pos:pos + value_len])
        pos += value_len
        entries.append((key, value))
    return entries


def _read_sstable(path: str) -> Dict[bytes, bytes]:
    """All (key, value) pairs of an SSTable file."""
    with open(path, 'rb') as f:
        data = f.read()
    footer = data[-48:]
    magic = struct.unpack_from('<Q', footer, 40)[0]
    if magic != _TABLE_MAGIC:
        raise ValueError('%s: not an SSTable (bad magic).' % path)
    buf = memoryview(footer)
    meta_off, pos = _read_varint(buf, 0)
    meta_size, pos = _read_varint(buf, pos)
    index_off, pos = _read_varint(buf, pos)
    index_size, pos = _read_varint(buf, pos)
    index_block = _read_block(data, index_off, index_size)
    result: Dict[bytes, bytes] = {}
    for _, handle in _parse_block_entries(index_block):
        hbuf = memoryview(handle)
        off, hpos = _read_varint(hbuf, 0)
        size, _ = _read_varint(hbuf, hpos)
        for key, value in _parse_block_entries(_read_block(data, off,
                                                           size)):
            result[key] = value
    return result


# TF DataType enum values read and written here.
_DTYPES = {1: np.dtype('<f4'), 2: np.dtype('<f8'), 3: np.dtype('<i4'),
           7: np.dtype(object),  # DT_STRING
           9: np.dtype('<i8'), 10: np.dtype(bool)}


def _parse_bundle_entry(value: bytes) -> Dict:
    """BundleEntryProto: dtype(1) shape(2) shard(3) offset(4) size(5)."""
    buf = memoryview(value)
    entry = {'dtype': 1, 'shape': [], 'shard_id': 0, 'offset': 0,
             'size': 0}
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
            if field == 1:
                entry['dtype'] = v
            elif field == 3:
                entry['shard_id'] = v
            elif field == 4:
                entry['offset'] = v
            elif field == 5:
                entry['size'] = v
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            payload = buf[pos:pos + length]
            pos += length
            if field == 2:  # TensorShapeProto: repeated Dim{size=1}.
                spos, send = 0, len(payload)
                dims = []
                while spos < send:
                    stag, spos = _read_varint(payload, spos)
                    if stag >> 3 == 2 and stag & 7 == 2:   # dim
                        dlen, spos = _read_varint(payload, spos)
                        dbuf = payload[spos:spos + dlen]
                        spos += dlen
                        dpos = 0
                        dim_size = 0
                        while dpos < dlen:
                            dtag, dpos = _read_varint(dbuf, dpos)
                            if dtag >> 3 == 1 and dtag & 7 == 0:
                                dim_size, dpos = _read_varint(dbuf,
                                                              dpos)
                            elif dtag & 7 == 2:
                                # Skip other Dim fields (a name, field
                                # 2): a named Dim serialized before its
                                # size must keep the dimension.
                                dskip, dpos = _read_varint(dbuf, dpos)
                                dpos += dskip
                            elif dtag & 7 == 0:
                                _, dpos = _read_varint(dbuf, dpos)
                            else:
                                break
                        dims.append(dim_size)
                    else:
                        slen, spos = _read_varint(payload, spos)
                        spos += slen
                entry['shape'] = dims
        elif wire == 5:
            pos += 4   # fixed32 (crc32c, field 6).
        elif wire == 1:
            pos += 8   # fixed64.
        else:
            raise ValueError('BundleEntry: unexpected wire type %d' % wire)
    return entry


# --------------------------------------------------------------------------
# Writer side


_DTYPE_CODES = {np.dtype('<f4'): 1, np.dtype('<f8'): 2,
                np.dtype('<i4'): 3, np.dtype(object): 7,
                np.dtype('<i8'): 9, np.dtype(bool): 10}


def _varint_bytes(value: int) -> bytes:
    out = bytearray()
    _write_varint(out, value)
    return bytes(out)


def _encode_shape_proto(shape) -> bytes:
    """TensorShapeProto: repeated Dim(2){size(1)}."""
    out = bytearray()
    for dim in shape:
        dim_msg = b'\x08' + _varint_bytes(int(dim))       # size = 1
        out += b'\x12' + _varint_bytes(len(dim_msg)) + dim_msg
    return bytes(out)


def _encode_bundle_entry(dtype_code: int, shape, offset: int,
                         size: int, crc: int) -> bytes:
    """BundleEntryProto: dtype(1) shape(2) offset(4) size(5) crc32c(6)."""
    out = bytearray()
    out += b'\x08' + _varint_bytes(dtype_code)
    shape_msg = _encode_shape_proto(shape)
    out += b'\x12' + _varint_bytes(len(shape_msg)) + shape_msg
    if offset:
        out += b'\x20' + _varint_bytes(offset)
    out += b'\x28' + _varint_bytes(size)
    out += b'\x35' + struct.pack('<I', crc)               # fixed32
    return bytes(out)


def _encode_bundle_header(num_shards: int = 1) -> bytes:
    """BundleHeaderProto: num_shards(1) endianness(2=LITTLE default)
    version(3){producer(1)=1}."""
    version_msg = b'\x08\x01'
    return (b'\x08' + _varint_bytes(num_shards) +
            b'\x1a' + _varint_bytes(len(version_msg)) + version_msg)


def _encode_string_tensor(arr: np.ndarray):
    """DT_STRING region + its entry checksum.

    Layout (tensor_bundle.cc WriteStringTensor): varint lengths, a
    masked crc32c of the lengths as a uint32 array, then the
    concatenated string bytes. The BundleEntry checksum covers (uint32
    length words || masked length-crc field || string bytes), the region
    with the lengths re-encoded as fixed u32 words, so it is returned
    alongside."""
    values = [v if isinstance(v, bytes) else str(v).encode('utf-8')
              for v in arr.reshape(-1)]
    lengths = b''.join(_varint_bytes(len(v)) for v in values)
    length_words = struct.pack('<%dI' % len(values),
                               *[len(v) for v in values])
    joined = b''.join(values)
    crc_field = struct.pack('<I', masked_crc32c(length_words))
    region = lengths + crc_field + joined
    return region, masked_crc32c(length_words + crc_field + joined)


def _block_bytes(entries: List[Tuple[bytes, bytes]]) -> bytes:
    """One uncompressed LevelDB table block (no prefix compression:
    shared=0 for every entry; single restart at 0)."""
    out = bytearray()
    for key, value in entries:
        out += _varint_bytes(0)
        out += _varint_bytes(len(key))
        out += _varint_bytes(len(value))
        out += key
        out += value
    out += struct.pack('<I', 0)       # restart offset 0
    out += struct.pack('<I', 1)       # num_restarts
    return bytes(out)


def _append_block(out: bytearray, block: bytes) -> Tuple[int, int]:
    """Appends block + trailer (type 0, masked crc over block+type);
    returns the BlockHandle (offset, size)."""
    offset = len(out)
    out += block
    out += b'\x00'
    out += struct.pack('<I', masked_crc32c(block + b'\x00'))
    return offset, len(block)


def write_tensor_bundle(prefix: str,
                        tensors: Dict[str, np.ndarray]) -> None:
    """Writes ``prefix + '.index'`` / ``prefix + '.data-00000-of-00001'``,
    a TensorFlow-readable TensorBundle, without TensorFlow.

    Accepts float32/float64/int32/int64/bool arrays and DT_STRING
    object arrays (bytes or str elements). Keys are checkpoint names
    (e.g. ``variables/0/.ATTRIBUTES/VARIABLE_VALUE``).
    """
    # Checksum conventions differ within the format: the BundleEntry
    # crc32c field is masked, the DT_STRING length-table crc is masked
    # but computed over the lengths as fixed uint32 words rather than
    # the varint bytes written (_encode_string_tensor), and the LevelDB
    # block trailers are masked.
    data = bytearray()
    entries: List[Tuple[bytes, bytes]] = []
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        if arr.dtype.kind in 'US':
            arr = arr.astype(object)
        entry_crc = None
        if arr.dtype == object:
            dtype_code = 7
            raw, entry_crc = _encode_string_tensor(arr)
        else:
            if arr.dtype.kind == 'f' and arr.dtype.itemsize == 4:
                arr = arr.astype('<f4')
            elif arr.dtype.kind == 'f':
                arr = arr.astype('<f8')
            elif arr.dtype == bool:
                pass
            elif arr.dtype.kind in 'iu':
                arr = arr.astype('<i8' if arr.dtype.itemsize > 4
                                 else '<i4')
            else:
                raise TypeError('Unsupported dtype %s for %s' %
                                (arr.dtype, name))
            dtype_code = _DTYPE_CODES[arr.dtype]
            raw = arr.tobytes()
        offset = len(data)
        data += raw
        if entry_crc is None:
            entry_crc = masked_crc32c(raw)
        entries.append((
            name.encode('utf-8'),
            _encode_bundle_entry(dtype_code, arr.shape, offset,
                                 len(raw), entry_crc)))
    entries.sort()
    entries.insert(0, (b'', _encode_bundle_header()))

    index = bytearray()
    data_off, data_size = _append_block(index, _block_bytes(entries))
    meta_off, meta_size = _append_block(index, _block_bytes([]))
    last_key = entries[-1][0]
    data_handle = _varint_bytes(data_off) + _varint_bytes(data_size)
    idx_off, idx_size = _append_block(
        index, _block_bytes([(last_key, data_handle)]))
    footer = bytearray()
    footer += _varint_bytes(meta_off) + _varint_bytes(meta_size)
    footer += _varint_bytes(idx_off) + _varint_bytes(idx_size)
    footer += b'\x00' * (40 - len(footer))
    footer += struct.pack('<Q', _TABLE_MAGIC)
    index += footer

    with open(prefix + '.data-00000-of-00001', 'wb') as f:
        f.write(bytes(data))
    with open(prefix + '.index', 'wb') as f:
        f.write(bytes(index))


def read_tensor_bundle(prefix: str) -> Dict[str, np.ndarray]:
    """Reads all tensors of a bundle, e.g. prefix='.../variables'.

    Returns {variable name: array}; DT_STRING tensors come back as
    object arrays of bytes. The internal _CHECKPOINTABLE_OBJECT_GRAPH
    entry is skipped, and so is a tensor of a dtype outside _DTYPES
    (DT_HALF, DT_BFLOAT16), without a word, as in the JAX reader. No
    checksum is verified on read.
    """
    table = _read_sstable(prefix + '.index')
    shards: Dict[int, bytes] = {}
    num_shards = 1
    tensors: Dict[str, np.ndarray] = {}
    for key, value in table.items():
        name = key.decode('utf-8', errors='replace')
        if not name or name.startswith('_CHECKPOINTABLE'):
            continue
        entry = _parse_bundle_entry(value)
        shard = entry['shard_id']
        if shard not in shards:
            path = '%s.data-%05d-of-%05d' % (prefix, shard, num_shards)
            if not os.path.exists(path):
                matches = glob.glob('%s.data-%05d-of-*' % (prefix, shard))
                if not matches:
                    raise FileNotFoundError(path)
                path = matches[0]
            with open(path, 'rb') as f:
                shards[shard] = f.read()
        raw = shards[shard][entry['offset']:entry['offset'] +
                            entry['size']]
        dtype = _DTYPES.get(entry['dtype'])
        if dtype is None:
            continue
        if entry['dtype'] == 7:  # DT_STRING: varint offsets then bytes.
            buf = memoryview(raw)
            count = int(np.prod(entry['shape'])) if entry['shape'] else 1
            lengths = []
            pos = 0
            for _ in range(count):
                v, pos = _read_varint(buf, pos)
                lengths.append(v)
            pos += 4  # crc32c of the length table (fixed32).
            values = []
            for length in lengths:
                values.append(bytes(buf[pos:pos + length]))
                pos += length
            arr = np.array(values, dtype=object).reshape(
                entry['shape'] or ())
        else:
            arr = np.frombuffer(raw, dtype=dtype).reshape(entry['shape'])
        tensors[name] = arr
    return tensors
