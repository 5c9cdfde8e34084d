"""Pure-Python EDF/EDF+ and BDF reader and writer.

Copy of telluride_decoding_tpu/io/edf.py for the port. EDF is a fixed
layout (ASCII headers, then data records of 16-bit samples with a
linear physical scaling, https://www.edfplus.info/specs/edf.html); BDF
is its 24-bit variant. parse_edf_file returns the dictionary the
ingest reads: labels, a signals matrix, sample_rates, header and
signal_headers. write_edf writes the same bytes as the JAX writer for
the same arrays.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def _ascii(field: bytes) -> str:
    return field.decode('ascii', errors='replace').strip()


def _num(field: bytes) -> float:
    text = _ascii(field)
    try:
        return float(text)
    except ValueError:
        return 0.0


def read_edf(path: str) -> Dict[str, Any]:
    """Reads an EDF or BDF file into header dicts + channel arrays.

    BDF (BioSemi) is the 24-bit variant: first header byte 0xFF and
    3-byte little-endian samples instead of EDF's 16-bit; everything
    else shares the layout.
    """
    with open(path, 'rb') as f:
        raw = f.read()
    if len(raw) < 256:
        raise ValueError('%s: too short to be an EDF file.' % path)
    is_bdf = raw[0] == 0xFF
    header = {
        'version': _ascii(raw[0:8]),
        'patient': _ascii(raw[8:88]),
        'recording': _ascii(raw[88:168]),
        'startdate': _ascii(raw[168:176]),
        'starttime': _ascii(raw[176:184]),
        'reserved': _ascii(raw[192:236]),
    }
    header_bytes = int(_num(raw[184:192]))
    num_records = int(_num(raw[236:244]))
    record_duration = _num(raw[244:252])
    ns = int(_num(raw[252:256]))
    if ns <= 0:
        raise ValueError('%s: bad number of signals (%d).' % (path, ns))

    # Signal-header columns per the EDF spec: 16 label, 80 transducer,
    # 8 dimension, 8 phys min, 8 phys max, 8 dig min, 8 dig max,
    # 80 prefilter, 8 samples/record, 32 reserved — each column stored
    # for all ns signals before the next column starts.
    base = 256
    widths = [16, 80, 8, 8, 8, 8, 8, 80, 8, 32]

    def sig_field(col, i):
        start = base + sum(w * ns for w in widths[:col]) + widths[col] * i
        return raw[start:start + widths[col]]

    labels = [_ascii(sig_field(0, i)) for i in range(ns)]
    dims = [_ascii(sig_field(2, i)) for i in range(ns)]
    phys_min = [_num(sig_field(3, i)) for i in range(ns)]
    phys_max = [_num(sig_field(4, i)) for i in range(ns)]
    dig_min = [_num(sig_field(5, i)) for i in range(ns)]
    dig_max = [_num(sig_field(6, i)) for i in range(ns)]
    prefilter = [_ascii(sig_field(7, i)) for i in range(ns)]
    samples_per_record = [int(_num(sig_field(8, i))) for i in range(ns)]

    if record_duration <= 0:
        record_duration = 1.0
    sample_rates = [spr / record_duration for spr in samples_per_record]

    record_len = sum(samples_per_record)
    if is_bdf:
        # 24-bit LE samples: combine 3 bytes and sign-extend.
        bytes3 = np.frombuffer(raw, dtype=np.uint8, offset=header_bytes)
        usable = (bytes3.shape[0] // 3) * 3
        bytes3 = bytes3[:usable].reshape(-1, 3).astype(np.int32)
        data = (bytes3[:, 0] | (bytes3[:, 1] << 8) | (bytes3[:, 2] << 16))
        data = np.where(data >= (1 << 23), data - (1 << 24), data)
    else:
        # Tolerate truncation at an odd byte offset (acquisition killed
        # mid-sample): frombuffer requires an even data region, so
        # slice to one — mirrors the BDF branch's (n // 3) * 3.
        usable = ((len(raw) - header_bytes) // 2) * 2
        data = np.frombuffer(raw[header_bytes:header_bytes + usable],
                             dtype='<i2')
    if record_len <= 0:
        raise ValueError('%s: zero samples per record.' % path)
    if num_records < 0:  # Unknown length: infer from the file size.
        num_records = data.shape[0] // record_len
    # Truncated recordings (interrupted acquisition) are common: read
    # the complete records actually present rather than crashing on a
    # header that promises more.
    num_records = min(num_records, data.shape[0] // record_len)
    data = data[:num_records * record_len].reshape(num_records, record_len)

    signals: List[np.ndarray] = []
    col = 0
    for i in range(ns):
        spr = samples_per_record[i]
        digital = data[:, col:col + spr].reshape(-1).astype(np.float64)
        col += spr
        dscale = dig_max[i] - dig_min[i]
        if dscale == 0:
            dscale = 1.0
        gain = (phys_max[i] - phys_min[i]) / dscale
        signals.append(phys_min[i] + gain * (digital - dig_min[i]))

    signal_headers = [
        {'label': labels[i], 'dimension': dims[i],
         'sample_rate': sample_rates[i],
         'physical_min': phys_min[i], 'physical_max': phys_max[i],
         'digital_min': dig_min[i], 'digital_max': dig_max[i],
         'prefilter': prefilter[i]}
        for i in range(ns)]
    return {'header': header, 'labels': labels, 'signal_list': signals,
            'sample_rates': np.array(sample_rates),
            'signal_headers': signal_headers,
            'num_records': num_records,
            'record_duration': record_duration}


def parse_edf_file(sample_edf_file: str) -> Dict[str, Any]:
    """Reference-shaped EDF parse (ingest.py:746-776): a dict with
    labels, a [n_signals, n_samples] matrix (sized by the first
    signal, as pyedflib's usage there assumes), sample_rates, header,
    signal_headers."""
    parsed = read_edf(sample_edf_file)
    signals = parsed['signal_list']
    n = len(signals)
    length = signals[0].shape[0] if n else 0
    matrix = np.zeros((n, length))
    for i, sig in enumerate(signals):
        m = min(length, sig.shape[0])
        matrix[i, :m] = sig[:m]
    return {'labels': parsed['labels'],
            'signals': matrix,
            'sample_rates': parsed['sample_rates'],
            'header': parsed['header'],
            'signal_headers': parsed['signal_headers']}


def _pad_ascii(text: str, width: int) -> bytes:
    encoded = str(text).encode('ascii', errors='replace')[:width]
    return encoded + b' ' * (width - len(encoded))


def _format_num8(v: float, direction: int = 0) -> str:
    """<= 8-char decimal rendering for EDF numeric header fields.

    '%g' can exceed 8 chars (e.g. -1.23457e+06 is 12); blindly
    truncating such a rendering corrupts the value by orders of
    magnitude on read-back, so precision is reduced until the string
    fits. direction=-1 forces the result <= v and +1 forces >= v —
    physical minima round DOWN and maxima UP so the written range
    always CONTAINS the data (an inward-rounded bound silently clips
    the signal's extremes).
    """
    if v == 0 or not math.isfinite(v):
        if v == 0:
            return '0'
        raise ValueError('Cannot represent %r in an 8-char EDF field.'
                         % v)
    for prec in range(8, 0, -1):
        if direction == 0:
            cand = v
        else:
            scale = 10.0 ** (math.floor(math.log10(abs(v))) - prec + 1)
            cand = (math.floor(v / scale) if direction < 0
                    else math.ceil(v / scale)) * scale
        s = '%.*g' % (prec, cand)
        if len(s) > 8:
            continue
        f = float(s)
        if direction == 0 or (direction < 0 and f <= v) or \
                (direction > 0 and f >= v):
            return s
    raise ValueError('Cannot represent %r in an 8-char EDF field.' % v)


def write_edf(path: str, signals: Sequence[np.ndarray],
              labels: Sequence[str], sample_rates: Sequence[float],
              record_duration: float = 1.0,
              physical_range: Optional[Sequence[float]] = None,
              patient: str = 'X', recording: str = 'X',
              bdf: bool = False):
    """Writes float signals as EDF (int16) or BDF (24-bit) files."""
    ns = len(signals)
    if not (len(labels) == len(sample_rates) == ns):
        raise ValueError('signals, labels, sample_rates must align.')
    signals = [np.asarray(s, np.float64).reshape(-1) for s in signals]
    # The duration header is an 8-char ASCII decimal and readers
    # reconstruct sample rates as spr / parsed_duration, so an
    # unrepresentable duration (e.g. 1/30 s) drifts every read-back
    # rate. Scale the data record by a small integer until the
    # duration is exactly representable (1/30 s x 3 = 0.1 s — exact);
    # if nothing up to 60x lands, fall back to the quantized rendering
    # and derive spr from IT so writer and header at least agree.
    requested = record_duration
    for k in range(1, 61):
        cand = requested * k
        rendered = float(_format_num8(cand))
        if abs(rendered - cand) <= 1e-12 * max(1.0, abs(cand)):
            record_duration = rendered
            break
    else:
        record_duration = float(_format_num8(requested))
    samples_per_record = [int(round(sr * record_duration))
                          for sr in sample_rates]
    if any(spr <= 0 for spr in samples_per_record):
        raise ValueError('sample_rate * record_duration must round to at '
                         'least 1 sample per record (rates %s, duration '
                         '%g).' % (list(sample_rates), record_duration))
    if physical_range is not None and \
            physical_range[1] <= physical_range[0]:
        raise ValueError('physical_range must satisfy max > min, got %s.'
                         % (tuple(physical_range),))
    num_records = max(
        int(math.ceil(s.shape[0] / spr))
        for s, spr in zip(signals, samples_per_record))

    dig_range = (1 << 24) - 1 if bdf else 65535
    dig_min = -(1 << 23) if bdf else -32768
    dig_max = (1 << 23) - 1 if bdf else 32767
    phys_mins, phys_maxs = [], []
    digital_rows = []
    for sig, spr in zip(signals, samples_per_record):
        total = num_records * spr
        padded = np.zeros(total)
        padded[:sig.shape[0]] = sig
        if physical_range is not None:
            lo, hi = physical_range
        else:
            lo = float(np.min(padded))
            hi = float(np.max(padded))
            if hi <= lo:
                hi = lo + 1.0
        # Quantize the bounds to their 8-char header rendering FIRST:
        # the reader reconstructs with the parsed header values, so the
        # digital scaling must use exactly what the header will say.
        # Directed rounding (min down, max up) keeps the data inside
        # the written range — nothing clips.
        lo = float(_format_num8(lo, direction=-1)) if lo else 0.0
        hi = float(_format_num8(hi, direction=1)) if hi else 0.0
        if hi <= lo:
            hi = float(_format_num8(lo + max(1.0, abs(lo) * 1e-3),
                                    direction=1))
        gain = (hi - lo) / dig_range
        digital = np.round((padded - lo) / gain + dig_min)
        digital = np.clip(digital, dig_min, dig_max).astype(np.int32)
        if bdf:
            u = (digital & 0xFFFFFF).astype(np.uint32)
            row_bytes = np.stack([u & 0xFF, (u >> 8) & 0xFF,
                                  (u >> 16) & 0xFF],
                                 axis=1).astype(np.uint8)
            digital_rows.append(row_bytes.reshape(num_records, spr * 3))
        else:
            digital_rows.append(digital.astype('<i2').reshape(
                num_records, spr))
        phys_mins.append(lo)
        phys_maxs.append(hi)

    header_bytes = 256 + 256 * ns
    now = datetime.datetime(2000, 1, 1)
    out = bytearray()
    if bdf:
        out += b'\xffBIOSEMI'
    else:
        out += _pad_ascii('0', 8)
    out += _pad_ascii(patient, 80)
    out += _pad_ascii(recording, 80)
    out += _pad_ascii(now.strftime('%d.%m.%y'), 8)
    out += _pad_ascii(now.strftime('%H.%M.%S'), 8)
    out += _pad_ascii(str(header_bytes), 8)
    # BDF readers (pyedflib/MNE/EDFbrowser) select 24-bit decoding by
    # the '24BIT' marker in the reserved field.
    out += _pad_ascii('24BIT' if bdf else '', 44)
    out += _pad_ascii(str(num_records), 8)
    out += _pad_ascii(_format_num8(record_duration), 8)
    out += _pad_ascii(str(ns), 4)

    def column(values, width):
        return b''.join(_pad_ascii(v, width) for v in values)

    out += column(labels, 16)
    out += column([''] * ns, 80)                      # transducer
    out += column(['uV'] * ns, 8)                     # dimension
    out += column([_format_num8(v) for v in phys_mins], 8)
    out += column([_format_num8(v) for v in phys_maxs], 8)
    out += column([str(dig_min)] * ns, 8)
    out += column([str(dig_max)] * ns, 8)
    out += column([''] * ns, 80)                      # prefilter
    out += column([str(s) for s in samples_per_record], 8)
    out += column([''] * ns, 32)                      # reserved

    for r in range(num_records):
        for row in digital_rows:
            out += row[r].tobytes()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'wb') as f:
        f.write(bytes(out))
