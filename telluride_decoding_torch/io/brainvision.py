"""BrainVision (.vhdr/.eeg) reader.

Copy of telluride_decoding_tpu/io/brainvision.py for the port: the
INI-style .vhdr parse, the IEEE_FLOAT_32 .eeg read with $b filename
expansion and per-channel resolution scaling, and the BvBrainDataFile
adapter. The sample rate is 1e6 / SamplingInterval (microseconds).
"""

from __future__ import annotations

import collections
import os
import re
from typing import Dict, Optional

import numpy as np

from telluride_decoding_torch.io.ingest import BrainDataFile


def parse_bv_keywords(section: str) -> 'collections.OrderedDict':
    """Parses one [Section] of key=value lines into an ordered dict."""
    section = section.split(']', 1)[1]
    section_dict = collections.OrderedDict()
    for key_value in section.split('\n'):
        if not key_value or key_value[0] == ';':
            continue
        if '=' in key_value:
            key, value = key_value.split('=', 1)
            key = key.strip()
            value = value.strip()
            try:
                value = int(value) if value.isdigit() else float(value)
            except ValueError:
                pass
            section_dict[key] = value
    return section_dict


def parse_bv_header(hdr: str) -> Dict[str, Dict]:
    """Parses the .vhdr INI content into per-section dictionaries."""
    section_list = re.split(r'^\[', hdr, flags=re.MULTILINE)
    sections: Dict[str, Dict] = {}
    for section in section_list:
        if section.startswith('Common Infos'):
            sections['Common Infos'] = parse_bv_keywords(section)
        elif section.startswith('Binary Infos'):
            sections['Binary Infos'] = parse_bv_keywords(section)
        elif section.startswith('Channel Infos'):
            channel_dict = parse_bv_keywords(section)
            for key, vals in channel_dict.items():
                if not isinstance(vals, str):
                    raise TypeError('Expected a string of key-vals, not a '
                                    '%s.' % type(vals))
                name, ref_name, resolution, unit = vals.split(',')
                channel_dict[key] = {
                    'channel_name': name,
                    'reference_channel_name': ref_name,
                    'resolution': float(resolution),
                    'unit': unit,
                }
            sections['Channel Infos'] = channel_dict
        elif section.startswith('Comment'):
            sections['Comment'] = section.split(']', 1)[1].split('\n')
    return sections


def read_bv_file(header_filename: str):
    """Reads a .vhdr + .eeg pair; returns (header dict, [N, C] data)."""
    if not header_filename.endswith('.vhdr'):
        header_filename += '.vhdr'
    with open(header_filename, 'r') as fp:
        header = parse_bv_header(fp.read())
    data_filename = header['Common Infos']['DataFile']
    if '$b' in data_filename:
        basename = header_filename.rsplit('.', 1)[0]
        data_filename = data_filename.replace('$b', basename)
    if '/' in header_filename and '/' not in data_filename:
        data_filename = os.path.join(os.path.dirname(header_filename),
                                     data_filename)
    if header['Binary Infos']['BinaryFormat'] != 'IEEE_FLOAT_32':
        raise ValueError('Can\'t read BrainVision data that has format %s' %
                         header['Binary Infos']['BinaryFormat'])
    with open(data_filename, 'rb') as f:
        data = np.frombuffer(f.read(), dtype='<f4')
    num_channels = header['Common Infos']['NumberOfChannels']
    return header, np.reshape(data, (-1, num_channels))


class BvBrainDataFile(BrainDataFile):
    """BrainVision recordings as a BrainDataFile."""

    def __init__(self, filename, data_type=None, **kwds):
        self._header: Dict = {}
        self._data: Optional[np.ndarray] = None
        super().__init__(filename, data_type=data_type, **kwds)

    def load_all_data(self, data_dir: str):
        if not os.path.exists(data_dir):
            raise IOError('Data_dir does not exist: %s' % data_dir)
        self._header, self._data = read_bv_file(
            os.path.join(data_dir, self._data_filename))

    @property
    def signal_names(self):
        infos = self._header['Channel Infos']
        return [infos[k]['channel_name'] for k in infos]

    def signal_values(self, name: str):
        if not isinstance(name, str):
            raise ValueError('Must search for values with a string name.')
        index = self.find_channel_index(name)
        resolution = self.find_channel_resolution(name)
        if index is not None:
            return self._data[:, index] * resolution
        return None

    def signal_fs(self, name) -> float:
        del name
        return 1e6 / float(self._header['Common Infos']['SamplingInterval'])

    def find_channel_index(self, desired_label: str = 'TRIG'):
        infos = self._header['Channel Infos']
        for index, label in enumerate(infos):
            if infos[label]['channel_name'] == desired_label:
                return index
        return None

    def find_channel_resolution(self, desired_label: str = 'TRIG'):
        infos = self._header['Channel Infos']
        for label in infos:
            if infos[label]['channel_name'] == desired_label:
                return infos[label]['resolution']
        return None

