"""A raw snappy encoder, and TensorBundle indexes rewritten with snappy
blocks, for testing the TF-free bundle readers.

TensorFlow may write an SSTable (a bundle's ``.index``) whose blocks are
snappy-compressed (trailer type 1); both packages' ``write_tensor_bundle``
write uncompressed blocks (type 0), and no snappy library is installed.
``snappy_compress`` writes literals and copies (1-, 2- or 4-byte offsets)
in the raw snappy format (format_description.txt), and ``snappy_index``
rewrites every block of an index as type 1 with its masked crc32c
recomputed. ``chip_smoke.py`` (phase 13) and the CPU tests
(tests/test_torch_tf_checkpoint.py) read such indexes with either
package's reader. Nothing here imports a package of the repo at import
time.
"""

import struct

_TABLE_MAGIC = 0xDB4775248B80FB57


def _varint(value):
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _read_varint(buf, pos):
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def literal(chunk):
    """One literal element: a tag of length - 1 (up to 60 in the tag,
    else in 1-4 following bytes), then the bytes."""
    n = len(chunk) - 1
    if n < 60:
        return bytes([n << 2]) + chunk
    extra = (n.bit_length() + 7) // 8
    return bytes([(59 + extra) << 2]) + n.to_bytes(extra, 'little') + chunk


def copy(offset, length, kind=None):
    """One copy element of ``length`` bytes from ``offset`` back. ``kind``
    1 (length 4-11, offset < 2048), 2 (length 1-64, offset < 65536) or 4
    (length 1-64) is the size of the offset; None takes the smallest."""
    if kind is None:
        kind = 1 if 4 <= length <= 11 and offset < 2048 else (
            2 if offset < 65536 else 4)
    if kind == 1:
        return bytes([((offset >> 8) << 5) | ((length - 4) << 2) | 1,
                      offset & 0xFF])
    if kind == 2:
        return bytes([((length - 1) << 2) | 2]) + struct.pack('<H', offset)
    return bytes([((length - 1) << 2) | 3]) + struct.pack('<I', offset)


def snappy_compress(data, kind=None, max_offset=1 << 20):
    """``data`` in raw snappy: greedy matches of at least 4 bytes found
    through a table of the last position of each 4-byte string, copies of
    at most 64 bytes (11 for a 1-byte offset), the rest as literals.
    ``kind`` forces the offset size of every copy, as in ``copy``."""
    data = bytes(data)
    max_offset = min(max_offset, {1: 2047, 2: 65535}.get(kind, max_offset))
    out = bytearray(_varint(len(data)))
    last = {}
    pos = start = 0
    while pos + 4 <= len(data):
        key = data[pos:pos + 4]
        cand = last.get(key)
        last[key] = pos
        if cand is None or pos - cand > max_offset:
            pos += 1
            continue
        length = 4
        while pos + length < len(data) and \
                data[cand + length] == data[pos + length]:
            length += 1
        if start < pos:
            for i in range(start, pos, 64):
                out += literal(data[i:min(i + 64, pos)])
        offset = pos - cand
        step_max = 11 if kind == 1 else 64
        done = 0
        while length - done >= 4 or (kind != 1 and length - done > 0):
            step = min(step_max, length - done)
            out += copy(offset, step, kind)
            done += step
        pos += done
        start = pos
    for i in range(start, len(data), 64):
        out += literal(data[i:i + 64])
    return bytes(out)


def snappy_index(src, dst, masked_crc32c, kind=None):
    """Writes the SSTable ``src`` to ``dst`` with every block (data,
    metaindex and index) snappy-compressed: type byte 1 and the masked
    crc32c over the compressed bytes and the type, by ``masked_crc32c``.
    Returns the number of blocks rewritten."""
    with open(src, 'rb') as f:
        data = f.read()
    footer = data[-48:]
    meta_off, pos = _read_varint(footer, 0)
    meta_size, pos = _read_varint(footer, pos)
    index_off, pos = _read_varint(footer, pos)
    index_size, _ = _read_varint(footer, pos)

    def block(offset, size):
        if data[offset + size] != 0:
            raise ValueError('block at %d is already compressed' % offset)
        return data[offset:offset + size]
    index = block(index_off, index_size)
    num_restarts = struct.unpack_from('<I', index, len(index) - 4)[0]
    if num_restarts != 1:
        raise ValueError('index block with %d restarts' % num_restarts)
    entries, pos, key = [], 0, b''
    while pos < len(index) - 8:
        shared, pos = _read_varint(index, pos)
        non_shared, pos = _read_varint(index, pos)
        value_len, pos = _read_varint(index, pos)
        key = key[:shared] + index[pos:pos + non_shared]
        pos += non_shared
        handle = index[pos:pos + value_len]
        pos += value_len
        off, hpos = _read_varint(handle, 0)
        size, _ = _read_varint(handle, hpos)
        entries.append((key, off, size))

    out = bytearray()

    def append(raw):
        packed = snappy_compress(raw, kind)
        offset = len(out)
        out.extend(packed + b'\x01')
        out.extend(struct.pack('<I', masked_crc32c(packed + b'\x01')))
        return _varint(offset) + _varint(len(packed))
    new_index = bytearray()
    for key, off, size in entries:
        handle = append(block(off, size))
        new_index += _varint(0) + _varint(len(key)) + _varint(len(handle))
        new_index += key + handle
    new_index += struct.pack('<II', 0, 1)
    new_footer = append(block(meta_off, meta_size))
    new_footer += append(bytes(new_index))
    new_footer += b'\x00' * (40 - len(new_footer))
    out += new_footer + struct.pack('<Q', _TABLE_MAGIC)
    with open(dst, 'wb') as f:
        f.write(bytes(out))
    return len(entries) + 2
