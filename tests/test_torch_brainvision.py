"""BrainVision reader of the PyTorch port vs the JAX package.

The reference fixture is absent, so each test writes its own .vhdr /
.eeg pair (write_bv_file of tools/raw_recordings.py, or a header written
by hand). Both readers must give the same header dict and data, and
the header fuzz of tests/test_fuzz_codecs.py:141-165 runs on both: the
port raises (the same exception type) or returns exactly where JAX does.
"""

import numpy as np
import pytest

from telluride_decoding_tpu.io import brainvision as jax_bv
from telluride_decoding_torch.io import brainvision
from tools import raw_recordings
from test_torch_edf import _mutate, outcome

HEADER = """Brain Vision Data Exchange Header File Version 1.0
; Data created by hand

[Common Infos]
Codepage=UTF-8
DataFile=rec.eeg
DataFormat=BINARY
; Data orientation: MULTIPLEXED=ch1,pt1, ch2,pt1 ...
DataOrientation=MULTIPLEXED
NumberOfChannels=3
SamplingInterval=2000

[Binary Infos]
BinaryFormat=IEEE_FLOAT_32

[Channel Infos]
Ch1=Fp1,,0.1,uV
Ch2=Fp2,REF,0.5,uV
Ch3=TRIG,,1,V

[Comment]
A comment line
another one
"""


def test_written_pair_reads_the_same_in_both(rng, tmp_path):
    data = 50 * rng.randn(300, 4)
    names = ['C3', 'C4', 'Cz', 'TRIG']
    resolutions = [0.1, 0.1, 0.05, 1.0]
    raw_recordings.write_bv_file(str(tmp_path / 'rec.vhdr'), data, names,
                                 512.0, resolutions)
    got = brainvision.read_bv_file(str(tmp_path / 'rec'))
    want = jax_bv.read_bv_file(str(tmp_path / 'rec'))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].shape == (300, 4)
    readers = []
    for module in (brainvision, jax_bv):
        reader = module.BvBrainDataFile('rec')
        reader.load_all_data(str(tmp_path))
        readers.append(reader)
    port, ref = readers
    assert port.signal_names == ref.signal_names == names
    for c, name in enumerate(names):
        np.testing.assert_array_equal(port.signal_values(name),
                                      ref.signal_values(name))
        # float32 samples of data / resolution, scaled back.
        np.testing.assert_allclose(port.signal_values(name), data[:, c],
                                   rtol=1e-6, atol=1e-5)
        assert port.signal_fs(name) == ref.signal_fs(name) == 512.0
    assert port.signal_values('missing') is None
    assert port.find_channel_index('TRIG') == 3
    assert port.find_channel_resolution('Cz') == 0.05
    with pytest.raises(ValueError):
        port.signal_values(3)


def test_hand_written_header_parses_the_same(rng, tmp_path):
    (tmp_path / 'rec.vhdr').write_text(HEADER)
    (tmp_path / 'rec.eeg').write_bytes(
        rng.randn(10, 3).astype('<f4').tobytes())
    got = brainvision.read_bv_file(str(tmp_path / 'rec.vhdr'))
    want = jax_bv.read_bv_file(str(tmp_path / 'rec.vhdr'))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    infos = got[0]['Channel Infos']
    assert infos['Ch2'] == {'channel_name': 'Fp2',
                            'reference_channel_name': 'REF',
                            'resolution': 0.5, 'unit': 'uV'}
    assert got[0]['Common Infos']['SamplingInterval'] == 2000
    assert got[0]['Comment'][1:3] == ['A comment line', 'another one']
    assert brainvision.parse_bv_keywords('[S]\nA=1\n;c=2\nB=x\nC=2.5') == \
        jax_bv.parse_bv_keywords('[S]\nA=1\n;c=2\nB=x\nC=2.5')


def test_other_binary_formats_are_refused(tmp_path):
    (tmp_path / 'rec.vhdr').write_text(HEADER.replace('IEEE_FLOAT_32',
                                                      'INT_16'))
    (tmp_path / 'rec.eeg').write_bytes(b'\0' * 12)
    for module in (brainvision, jax_bv):
        with pytest.raises(ValueError, match='INT_16'):
            module.read_bv_file(str(tmp_path / 'rec.vhdr'))
        with pytest.raises(IOError):
            module.BvBrainDataFile('rec').load_all_data(str(tmp_path / 'no'))


def test_bad_channel_line_is_refused():
    bad = HEADER.replace('Ch3=TRIG,,1,V', 'Ch3=7')
    for module in (brainvision, jax_bv):
        with pytest.raises(TypeError):
            module.parse_bv_header(bad)


def test_header_fuzz_matches_jax():
    rng = np.random.RandomState(6)
    for _ in range(40):
        blob = rng.randint(0, 256, size=int(rng.randint(0, 2048)),
                           dtype=np.uint8).tobytes()
        text = blob.decode('latin-1')
        assert outcome(brainvision.parse_bv_header, text) == \
            outcome(jax_bv.parse_bv_header, text)


def test_mutated_header_fuzz_matches_jax():
    rng = np.random.RandomState(7)
    base = HEADER.encode()
    for _ in range(40):
        text = _mutate(rng, base).decode('latin-1', 'replace')
        assert outcome(brainvision.parse_bv_header, text) == \
            outcome(jax_bv.parse_bv_header, text)
