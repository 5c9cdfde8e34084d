"""TF-free TFRecord + tf.train.Example I/O.

Port of telluride_decoding_tpu/data/records.py: the same wire formats,
so a file written by either package is byte-identical and reads in the
other. The reference stores all ingested data as TFRecord files of
tf.train.Example protos, one *frame* per record with float features
(reference ingest.py:1118-1172), and reads them back through
tf.data.TFRecordDataset (brain_data.py:756-760):

  * TFRecord framing: [len u64le][masked crc32c(len) u32le][payload]
    [masked crc32c(payload) u32le].
  * tf.train.Example proto: hand-rolled wire-format codec for the tiny
    Example/Features/Feature message family (float/int64/bytes lists).

Reading is vectorized: a whole file is scanned once, then all same-shaped
float features are decoded into one [num_frames, width] numpy array per
field, ready for one host-to-device copy.

CRC32C, record scanning and the all-float batch encode and decode go
through the native codec (telluride_decoding_torch._native), which
raises if it cannot be built; there is no pure-Python CRC. Non-float
features and files whose records disagree take the Python parser, as in
the JAX package. File reads skip validation by default (set
validate=True to check).
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from telluride_decoding_torch import _native

_MASK_DELTA = 0xA282EAD8


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``, by the native codec."""
    return int(_native.lib().tdt_crc32c(_data_ptr(data), len(data)))


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# Protobuf wire-format primitives (just enough for tf.train.Example).
# ---------------------------------------------------------------------------

def _write_varint(out: bytearray, value: int):
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    end = len(buf)
    while True:
        if pos >= end or shift > 63:
            # Truncated or runaway varint in a (non-CRC-validated)
            # payload: report as corruption, not a bare IndexError.
            raise CorruptRecordError(
                'truncated or oversized varint at byte %d' % pos)
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _length_delimited(field_number: int, payload: bytes) -> bytes:
    out = bytearray()
    _write_varint(out, (field_number << 3) | 2)
    _write_varint(out, len(payload))
    out.extend(payload)
    return bytes(out)


def encode_feature(value: np.ndarray) -> bytes:
    """Encodes one row as a tf.train.Feature (float/int64/bytes list)."""
    value = np.asarray(value)
    if value.dtype.kind == 'f':
        payload = value.astype('<f4').tobytes()
        # FloatList.value is field 1, packed: one length-delimited blob.
        float_list = _length_delimited(1, payload)
        return _length_delimited(2, float_list)      # Feature.float_list
    elif value.dtype.kind in 'iu':
        out = bytearray()
        for v in value.reshape(-1):
            _write_varint(out, int(v) & 0xFFFFFFFFFFFFFFFF)
        int64_list = _length_delimited(1, bytes(out))
        return _length_delimited(3, int64_list)      # Feature.int64_list
    elif value.dtype.kind in 'SU' or value.dtype == object:
        out = bytearray()
        for v in np.atleast_1d(value):
            b = v if isinstance(v, bytes) else str(v).encode('utf-8')
            out.extend(_length_delimited(1, b))
        return _length_delimited(1, bytes(out))      # Feature.bytes_list
    raise TypeError('Unsupported feature dtype: %s' % value.dtype)


def encode_example(features: Dict[str, np.ndarray]) -> bytes:
    """Encodes a dict of 1-D arrays as a serialized tf.train.Example."""
    body = bytearray()
    for name, value in features.items():
        key_bytes = _length_delimited(1, name.encode('utf-8'))
        val_bytes = _length_delimited(2, encode_feature(value))
        entry = key_bytes + val_bytes
        body.extend(_length_delimited(1, entry))     # Features.feature entry
    features_msg = _length_delimited(1, bytes(body))  # Example.features
    return features_msg


class FeatureSpec:
    """Shape/type of one feature, as discovered from a file.

    Mirrors the role of tf.io.FixedLenFeature in the reference
    (brain_data.py:887-927): ``shape`` is a one-element list with the
    width, ``dtype`` is a numpy dtype.
    """

    def __init__(self, width: int, dtype):
        self.shape = [width]
        self.dtype = np.dtype(dtype)

    def __repr__(self):
        return 'FeatureSpec(width=%d, dtype=%s)' % (self.shape[0], self.dtype)

    def __eq__(self, other):
        return (isinstance(other, FeatureSpec) and
                self.shape == other.shape and self.dtype == other.dtype)


def parse_example(data: Union[bytes, memoryview]
                  ) -> Dict[str, np.ndarray]:
    """Parses one serialized tf.train.Example into {name: 1-D array}."""
    buf = memoryview(data)
    result: Dict[str, np.ndarray] = {}
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        if tag >> 3 == 1 and tag & 7 == 2:           # Example.features
            flen, pos = _read_varint(buf, pos)
            _parse_features(buf[pos:pos + flen], result)
            pos += flen
        else:
            pos = _skip_field(buf, pos, tag)
    return result


def _skip_field(buf: memoryview, pos: int, tag: int) -> int:
    wire = tag & 7
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        length, pos = _read_varint(buf, pos)
        pos += length
    elif wire == 5:
        pos += 4
    else:
        raise ValueError('Unsupported wire type %d' % wire)
    return pos


def _parse_features(buf: memoryview, result: Dict[str, np.ndarray]):
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        if tag >> 3 == 1 and tag & 7 == 2:           # map entry
            elen, pos = _read_varint(buf, pos)
            _parse_map_entry(buf[pos:pos + elen], result)
            pos += elen
        else:
            pos = _skip_field(buf, pos, tag)


def _parse_map_entry(buf: memoryview, result: Dict[str, np.ndarray]):
    pos, end = 0, len(buf)
    key = None
    value_span = None
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        # Known fields are length-delimited; anything else (legal
        # unknown extensions with wire type 0/1/5) must be skipped by
        # wire type, not read as if a length prefix followed.
        if tag >> 3 == 1 and tag & 7 == 2:           # key
            length, pos = _read_varint(buf, pos)
            key = bytes(buf[pos:pos + length]).decode('utf-8')
            pos += length
        elif tag >> 3 == 2 and tag & 7 == 2:         # value (Feature)
            length, pos = _read_varint(buf, pos)
            value_span = buf[pos:pos + length]
            pos += length
        else:
            pos = _skip_field(buf, pos, tag)
    if key is not None and value_span is not None:
        result[key] = _parse_feature(value_span)


def _parse_feature(buf: memoryview) -> np.ndarray:
    # Repeated occurrences of the same embedded list message MERGE
    # (proto field-merge semantics: a writer may legally split one
    # float_list across several submessages), so accumulate every
    # occurrence instead of returning the first.
    pos, end = 0, len(buf)
    parts: List[np.ndarray] = []
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field = tag >> 3
        if tag & 7 != 2 or field not in (1, 2, 3):
            pos = _skip_field(buf, pos, tag)
            continue
        length, pos = _read_varint(buf, pos)
        inner = buf[pos:pos + length]
        pos += length
        if field == 2:                               # FloatList
            parts.append(_parse_packed_floats(inner))
        elif field == 3:                             # Int64List
            parts.append(_parse_packed_varints(inner))
        elif field == 1:                             # BytesList
            parts.append(_parse_bytes_list(inner))
    if not parts:
        return np.zeros((0,), np.float32)
    if len(parts) == 1:
        return parts[0]
    return np.concatenate(parts)


def _parse_packed_floats(buf: memoryview) -> np.ndarray:
    pos, end = 0, len(buf)
    chunks: List[np.ndarray] = []
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        if tag & 7 == 2:                             # packed
            length, pos = _read_varint(buf, pos)
            chunks.append(np.frombuffer(buf, '<f4', count=length // 4,
                                        offset=pos))
            pos += length
        elif tag & 7 == 5:                           # unpacked single float
            chunks.append(np.frombuffer(buf, '<f4', count=1, offset=pos))
            pos += 4
        else:
            pos = _skip_field(buf, pos, tag)
    if len(chunks) == 1:
        return chunks[0]
    return (np.concatenate(chunks) if chunks else np.zeros((0,), '<f4'))


def _parse_packed_varints(buf: memoryview) -> np.ndarray:
    pos, end = 0, len(buf)
    values: List[int] = []
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        if tag & 7 == 2:
            length, pos = _read_varint(buf, pos)
            stop = pos + length
            while pos < stop:
                v, pos = _read_varint(buf, pos)
                values.append(v - (1 << 64) if v >= (1 << 63) else v)
        elif tag & 7 == 0:
            v, pos = _read_varint(buf, pos)
            values.append(v - (1 << 64) if v >= (1 << 63) else v)
        else:
            pos = _skip_field(buf, pos, tag)
    return np.array(values, dtype=np.int64)


def _parse_bytes_list(buf: memoryview) -> np.ndarray:
    pos, end = 0, len(buf)
    values: List[bytes] = []
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        if tag & 7 != 2:            # Unknown non-length-delimited field.
            pos = _skip_field(buf, pos, tag)
            continue
        length, pos = _read_varint(buf, pos)
        values.append(bytes(buf[pos:pos + length]))
        pos += length
    return np.array(values, dtype=object)


# ---------------------------------------------------------------------------
# TFRecord file framing.
# ---------------------------------------------------------------------------

class CorruptRecordError(ValueError):
    pass


def iter_tfrecords(path: str, validate: bool = False
                   ) -> Iterator[memoryview]:
    """Yields the payload of each record in a TFRecord file."""
    with open(path, 'rb') as f:
        data = memoryview(f.read())
    pos, end = 0, len(data)
    while pos < end:
        if pos + 12 > end:
            raise CorruptRecordError('%s: truncated header at %d' %
                                     (path, pos))
        (length,) = struct.unpack_from('<Q', data, pos)
        if validate:
            (len_crc,) = struct.unpack_from('<I', data, pos + 8)
            if masked_crc32c(bytes(data[pos:pos + 8])) != len_crc:
                raise CorruptRecordError('%s: bad length crc at %d' %
                                         (path, pos))
        pos += 12
        if pos + length + 4 > end:
            raise CorruptRecordError('%s: truncated payload at %d' %
                                     (path, pos))
        payload = data[pos:pos + length]
        if validate:
            (data_crc,) = struct.unpack_from('<I', data, pos + length)
            if masked_crc32c(bytes(payload)) != data_crc:
                raise CorruptRecordError('%s: bad data crc at %d' %
                                         (path, pos))
        pos += length + 4
        yield payload


def write_tfrecords(path: str, payloads: Iterator[bytes]):
    """Writes serialized payloads to a TFRecord file (valid CRCs)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'wb') as f:
        for payload in payloads:
            header = struct.pack('<Q', len(payload))
            f.write(header)
            f.write(struct.pack('<I', masked_crc32c(header)))
            f.write(payload)
            f.write(struct.pack('<I', masked_crc32c(payload)))


def _data_ptr(data: bytes):
    """Zero-copy uint8 pointer into a bytes object for ctypes calls."""
    view = np.frombuffer(data, np.uint8)
    return view.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _native_scan(data: bytes, validate: bool = True):
    """('ok', offsets, lengths) of the records via the C++ scanner, or
    ('corrupt', None, None)."""
    lib = _native.lib()
    buf = _data_ptr(data)
    # First pass with zero capacity gets the count.
    count = lib.tdt_scan_records(buf, len(data), int(validate),
                                 None, None, 0)
    if count < 0:
        return 'corrupt', None, None
    offsets = np.zeros(count, np.int64)
    lengths = np.zeros(count, np.int64)
    lib.tdt_scan_records(
        buf, len(data), 0,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), count)
    return 'ok', offsets, lengths


def _native_validate(data: bytes, offsets: np.ndarray,
                     lengths: np.ndarray
                     ) -> Tuple[int, np.ndarray, np.ndarray]:
    """C-side Example validation + per-record schema summary.

    Returns (num_valid, feature_counts, key_hashes); num_valid equals
    len(offsets) iff every record parses as an Example.
    """
    lib = _native.lib()
    n = len(offsets)
    nfeat = np.zeros(n, np.int64)
    keyhash = np.zeros(n, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    ok = lib.tdt_validate_examples(
        _data_ptr(data), offsets.ctypes.data_as(i64p),
        lengths.ctypes.data_as(i64p), n,
        nfeat.ctypes.data_as(i64p), keyhash.ctypes.data_as(i64p))
    return int(ok), nfeat, keyhash


def count_tfrecords(path: str) -> Tuple[int, bool]:
    """Counts records and reports corruption (reference
    brain_data.py:930-956 semantics: returns (count, error_found))."""
    try:
        with open(path, 'rb') as f:
            data = f.read()
    except OSError:
        return 0, True
    status, offsets, lengths = _native_scan(data, validate=True)
    if status == 'ok':
        # Framing CRCs are validated natively; each payload must also
        # parse as an Example (the reference parses every record,
        # brain_data.py:947-953 Example.FromString) — validated in C
        # too, so a multimillion-record corpus never walks a Python
        # per-record loop.
        ok, _, _ = _native_validate(data, offsets, lengths)
        return int(ok), ok != len(offsets)
    # A corrupt file: the python path reports the partial count.
    count = 0
    try:
        for payload in iter_tfrecords(path, validate=True):
            parse_example(payload)
            count += 1
    except Exception:  # Any framing/parse error marks the file bad.
        return count, True
    return count, False


def discover_feature_shapes(path: str) -> Dict[str, FeatureSpec]:
    """Reads one record and reports {feature: FeatureSpec}.

    Mirrors reference brain_data.discover_feature_shapes
    (brain_data.py:887-927).
    """
    if not isinstance(path, str):
        raise TypeError('discover_feature_shapes: input must be a string '
                        'filename.')
    for payload in iter_tfrecords(path):
        example = parse_example(payload)
        specs = {}
        for name, value in example.items():
            specs[name] = FeatureSpec(value.shape[0], value.dtype)
        return specs
    raise ValueError('No records found in %s.' % path)


def read_tfrecords(path: str,
                   fields: Optional[List[str]] = None
                   ) -> Dict[str, np.ndarray]:
    """Reads an entire frame-per-record file into {field: [N, width]}.

    The whole-file array form uploads to the device in one transfer and
    feeds the lag-stacking kernel directly. Equivalent of reference
    ingest.read_tfrecords (ingest.py:1245-1289). All-float files decode
    through the C++ batch parser.
    """
    with open(path, 'rb') as f:
        data = f.read()
    status, offsets, lengths = _native_scan(data, validate=False)
    if status == 'ok':
        if len(offsets):
            specs = {}
            first = parse_example(
                memoryview(data)[offsets[0]:offsets[0] + lengths[0]])
            all_float = all(v.dtype == np.float32 for v in first.values())
            for name, value in first.items():
                specs[name] = value.shape[0]
            # The native reader takes its schema from record 0; a file
            # whose OTHER records carry extra/renamed features would
            # silently lose them. The C validator summarizes every
            # record's schema (feature count + key hash); any record
            # differing from record 0 punts to the python path, which
            # raises the detailed inconsistent-records error.
            schema_ok = False
            if all_float:
                # Skip the whole-file C validation scan when record 0
                # already rules out the fast path (non-float feature).
                ok, nfeat, keyhash = _native_validate(data, offsets,
                                                      lengths)
                schema_ok = (ok == len(offsets) and
                             bool(np.all(nfeat == nfeat[0])) and
                             bool(np.all(keyhash == keyhash[0])))
            if all_float and schema_ok:
                lib = _native.lib()
                buf = _data_ptr(data)
                n = len(offsets)
                result = {}
                for name, width in specs.items():
                    if fields is not None and name not in fields:
                        continue
                    out = np.zeros((n, width), np.float32)
                    got = lib.tdt_read_feature(
                        buf,
                        offsets.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_int64)),
                        lengths.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_int64)),
                        n, name.encode(),
                        out.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_float)), width)
                    if got != n:
                        break  # Malformed: fall back below.
                    result[name] = out
                else:
                    return result
    rows: Dict[str, List[np.ndarray]] = {}
    for payload in iter_tfrecords(path):
        example = parse_example(payload)
        for name, value in example.items():
            if fields is not None and name not in fields:
                continue
            rows.setdefault(name, []).append(value)
    counts = {name: len(values) for name, values in rows.items()}
    try:
        if len(set(counts.values())) > 1:
            # A feature present in only SOME records stacks fine per
            # feature but misaligns the streams — reject loudly.
            raise ValueError('ragged per-feature row counts')
        return {name: np.stack(values) for name, values in rows.items()}
    except ValueError as error:
        raise ValueError(
            '%s: inconsistent records (per-feature counts %s; a feature '
            'is missing from some records or changes width): %s' %
            (path, counts, error))


def convert_data_to_tfrecords(data_dict: Dict[str, np.ndarray],
                              path: str):
    """Writes {field: [N, width]} as N frame-per-record Examples.

    Same layout as reference ingest.convert_data_to_tfrecords
    (ingest.py:1118-1172): record i holds row i of every field.
    """
    arrays = {}
    num_frames = None
    for name, data in data_dict.items():
        data = np.asarray(data)
        if data.ndim == 1:
            data = data[:, None]
        if num_frames is None:
            num_frames = data.shape[0]
        elif data.shape[0] != num_frames:
            raise ValueError(
                'All fields must have the same number of frames: '
                '%s has %d, expected %d.' % (name, data.shape[0], num_frames))
        arrays[name] = data

    # Native batch encoder when every feature is float.
    if num_frames and all(v.dtype.kind == 'f' for v in arrays.values()):
        lib = _native.lib()
        names = list(arrays.keys())
        name_bytes = ''.join(names).encode()
        name_lens = np.array([len(n.encode()) for n in names], np.int64)
        widths = np.array([arrays[n].shape[1] for n in names], np.int64)
        f32 = [np.ascontiguousarray(arrays[n], np.float32) for n in names]
        ptrs = (ctypes.POINTER(ctypes.c_float) * len(names))(
            *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
              for a in f32])
        i64p = ctypes.POINTER(ctypes.c_int64)
        size = lib.tdt_encoded_size(
            name_lens.ctypes.data_as(i64p), widths.ctypes.data_as(i64p),
            len(names), num_frames)
        out = np.zeros(size, np.uint8)
        written = lib.tdt_encode_file(
            name_bytes, name_lens.ctypes.data_as(i64p),
            widths.ctypes.data_as(i64p), ptrs, len(names), num_frames,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), size)
        if written != size:
            raise RuntimeError('native encoder wrote %d of %d bytes for %s'
                               % (written, size, path))
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, 'wb') as f:
            f.write(out.tobytes())
        return

    def gen():
        for i in range(num_frames or 0):
            yield encode_example({k: v[i] for k, v in arrays.items()})

    write_tfrecords(path, gen())
