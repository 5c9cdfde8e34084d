"""TensorBoard event writer without TensorFlow (port of
utils/summaries.py).

Writes the tfevents wire format (TFRecord-framed Event protos) with the
port's record helpers: scalars as simple_value, text through the text
plugin's string-tensor encoding, so standard TensorBoard reads the
output.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Union

from telluride_decoding_torch.data.records import (_length_delimited,
                                                   _write_varint,
                                                   masked_crc32c)


def _varint_field(field_number: int, value: int) -> bytes:
    out = bytearray()
    _write_varint(out, field_number << 3)
    _write_varint(out, value)
    return bytes(out)


def _double_field(field_number: int, value: float) -> bytes:
    out = bytearray()
    _write_varint(out, (field_number << 3) | 1)
    out.extend(struct.pack('<d', value))
    return bytes(out)


def _float_field(field_number: int, value: float) -> bytes:
    out = bytearray()
    _write_varint(out, (field_number << 3) | 5)
    out.extend(struct.pack('<f', value))
    return bytes(out)


def _encode_event(step: int, payload: bytes = b'',
                  file_version: str = '') -> bytes:
    event = bytearray()
    event.extend(_double_field(1, time.time()))          # wall_time
    if step:
        event.extend(_varint_field(2, step))             # step
    if file_version:
        event.extend(_length_delimited(3, file_version.encode()))
    if payload:
        event.extend(_length_delimited(5, payload))      # summary
    return bytes(event)


def _frame_record(payload: bytes) -> bytes:
    header = struct.pack('<Q', len(payload))
    return (header + struct.pack('<I', masked_crc32c(header)) + payload +
            struct.pack('<I', masked_crc32c(payload)))


class SummaryWriter:
    """Appends scalar/text events to a tfevents file in ``logdir``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = 'events.out.tfevents.%d.%s' % (int(time.time()),
                                               socket.gethostname())
        self._path = os.path.join(logdir, fname)
        with open(self._path, 'ab') as f:
            f.write(_frame_record(_encode_event(0,
                                                file_version='brain.Event:2')))

    def scalar(self, tag: str, value: Union[float, int], step: int = 0):
        value_msg = (_length_delimited(1, tag.encode()) +
                     _float_field(2, float(value)))     # simple_value
        summary = _length_delimited(1, value_msg)        # Summary.value
        with open(self._path, 'ab') as f:
            f.write(_frame_record(_encode_event(step, summary)))

    def text(self, tag: str, text: str, step: int = 0):
        # TensorProto: dtype=DT_STRING(7), shape [1], string_val=[text].
        dim = _varint_field(1, 1)                        # Dim.size = 1
        shape = _length_delimited(2, dim)                # tensor_shape.dim
        tensor = (_varint_field(1, 7) + _length_delimited(2, shape) +
                  _length_delimited(8, text.encode()))   # string_val
        plugin = _length_delimited(1, b'text')           # plugin_name
        metadata = _length_delimited(1, plugin)          # plugin_data
        value_msg = (_length_delimited(1, (tag + '/text_summary').encode()) +
                     _length_delimited(8, tensor) +
                     _length_delimited(9, metadata))
        summary = _length_delimited(1, value_msg)
        with open(self._path, 'ab') as f:
            f.write(_frame_record(_encode_event(step, summary)))
