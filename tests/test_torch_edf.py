"""EDF/BDF reader and writer of the PyTorch port vs the JAX package.

The files come from both writers (EDF's 16-bit and BDF's 24-bit
samples, record durations that need a scaled data record). Reads must
give identical float64 arrays and headers, and writes identical bytes.
The hardening cases of tests/test_parser_hardening.py and the EDF fuzz
of tests/test_fuzz_codecs.py run on both readers: the port raises
(with the same exception type) or returns exactly where JAX does.
"""

import os

import numpy as np
import pytest

from telluride_decoding_tpu.io import edf as jax_edf
from telluride_decoding_tpu.io import ingest as jax_ingest
from telluride_decoding_torch.io import edf
from telluride_decoding_torch.io import ingest

N_GARBAGE = 40
N_MUTANTS = 40


def signals(rng, n, rates, scale=30.0):
    return [scale * rng.randn(int(n * r / rates[0])) for r in rates]


def assert_same_read(got, want):
    assert set(got) == set(want)
    for key in want:
        if key == 'signal_list':
            assert len(got[key]) == len(want[key])
            for g, w in zip(got[key], want[key]):
                assert g.dtype == w.dtype == np.float64
                np.testing.assert_array_equal(g, w)
        elif isinstance(want[key], np.ndarray):
            np.testing.assert_array_equal(got[key], want[key])
        else:
            assert got[key] == want[key]


def outcome(fn, *args):
    """('raised', exception type) or ('returned', value)."""
    try:
        return 'returned', fn(*args)
    except Exception as error:  # noqa: BLE001 - the property under test
        return 'raised', type(error)


def assert_same_outcome(port_fn, jax_fn, path):
    got, want = outcome(port_fn, path), outcome(jax_fn, path)
    assert got[0] == want[0], (got, want)
    if got[0] == 'raised':
        assert got[1] is want[1]
    else:
        assert_same_read(got[1], want[1])


WRITES = [
    dict(rates=[256.0], record_duration=1.0, bdf=False),
    dict(rates=[64.0, 32.0], record_duration=1.0, bdf=False),
    dict(rates=[512.0, 512.0, 512.0], record_duration=1.0, bdf=True),
    dict(rates=[30.0, 60.0], record_duration=1 / 30.0, bdf=False),
    dict(rates=[100.0], record_duration=0.37, bdf=True),
    dict(rates=[7.0], record_duration=1 / 7.0, bdf=False),
]


@pytest.mark.parametrize('case', WRITES,
                         ids=['edf', 'edf_two_rates', 'bdf', 'edf_1_30s',
                              'bdf_0_37s', 'edf_1_7s'])
def test_write_is_byte_identical_and_reads_match(rng, tmp_path, case):
    sigs = signals(rng, 700, case['rates'])
    labels = ['C%d' % i for i in range(len(sigs))]
    kwargs = dict(record_duration=case['record_duration'], bdf=case['bdf'])
    suffix = '.bdf' if case['bdf'] else '.edf'
    port_path = str(tmp_path / ('port' + suffix))
    jax_path = str(tmp_path / ('jax' + suffix))
    edf.write_edf(port_path, sigs, labels, case['rates'], **kwargs)
    jax_edf.write_edf(jax_path, sigs, labels, case['rates'], **kwargs)
    with open(port_path, 'rb') as f, open(jax_path, 'rb') as g:
        assert f.read() == g.read()
    for path in (port_path, jax_path):
        assert_same_read(edf.read_edf(path), jax_edf.read_edf(path))
        got, want = edf.parse_edf_file(path), jax_edf.parse_edf_file(path)
        assert got['labels'] == want['labels'] == labels
        assert got['header'] == want['header']
        assert got['signal_headers'] == want['signal_headers']
        np.testing.assert_array_equal(got['signals'], want['signals'])
        np.testing.assert_array_equal(got['sample_rates'],
                                      want['sample_rates'])
    # The quantization bounds the round trip: one step of the range.
    got = edf.read_edf(port_path)
    for sig, back, h in zip(sigs, got['signal_list'], got['signal_headers']):
        step = (h['physical_max'] - h['physical_min']) / (
            h['digital_max'] - h['digital_min'])
        assert np.abs(back[:sig.shape[0]] - sig).max() <= step


def test_physical_range_and_patient_fields(rng, tmp_path):
    sigs = signals(rng, 256, [128.0])
    for module, name in ((edf, 'port.edf'), (jax_edf, 'jax.edf')):
        module.write_edf(str(tmp_path / name), sigs, ['Fz'], [128.0],
                         physical_range=(-200, 200), patient='P 01',
                         recording='lab')
    with open(tmp_path / 'port.edf', 'rb') as f, \
            open(tmp_path / 'jax.edf', 'rb') as g:
        assert f.read() == g.read()
    header = edf.read_edf(str(tmp_path / 'port.edf'))['header']
    assert header['patient'] == 'P 01' and header['recording'] == 'lab'


@pytest.mark.parametrize('bad', [
    dict(labels=['A', 'B'], sample_rates=[64.0]),
    dict(labels=['A'], sample_rates=[0.4]),
    dict(labels=['A'], sample_rates=[64.0], physical_range=(5, 5)),
])
def test_write_rejects_what_jax_rejects(rng, tmp_path, bad):
    sig = [rng.randn(64)]
    with pytest.raises(ValueError):
        edf.write_edf(str(tmp_path / 'x.edf'), sig, **bad)
    with pytest.raises(ValueError):
        jax_edf.write_edf(str(tmp_path / 'y.edf'), sig, **bad)


# -- tests/test_parser_hardening.py's EDF cases on the port -----------------

def test_large_physical_values_round_trip(rng, tmp_path):
    path = str(tmp_path / 'big.edf')
    sig = (rng.randn(512) * 5e6 - 1234567.8)
    edf.write_edf(path, [sig], ['A1'], [256.0])
    parsed = edf.read_edf(path)
    assert_same_read(parsed, jax_edf.read_edf(path))
    h = parsed['signal_headers'][0]
    assert h['physical_min'] <= sig.min()
    assert h['physical_max'] >= sig.max()
    step = (h['physical_max'] - h['physical_min']) / 65535.0
    assert np.abs(parsed['signal_list'][0][:512] - sig).max() <= step


@pytest.mark.parametrize('value', [0.0, -1234567.8, 5.4321e-17,
                                   -9.87654321e+120, 1e308, -1e-308,
                                   123.456789, 1 / 30.0])
@pytest.mark.parametrize('direction', [-1, 0, 1])
def test_format_num8_matches_jax(value, direction):
    got = edf._format_num8(value, direction)
    assert got == jax_edf._format_num8(value, direction)
    assert len(got) <= 8
    if direction < 0:
        assert float(got) <= value
    elif direction > 0:
        assert float(got) >= value


@pytest.mark.parametrize('value', [float('nan'), float('inf')])
def test_format_num8_rejects_non_finite(value):
    with pytest.raises(ValueError):
        edf._format_num8(value)
    with pytest.raises(ValueError):
        jax_edf._format_num8(value)


@pytest.mark.parametrize('cut', [512, 513, 1, 0],
                         ids=['record', 'odd_byte', 'one_byte', 'none'])
@pytest.mark.parametrize('bdf', [False, True], ids=['edf', 'bdf'])
def test_truncated_file_reads_complete_records(rng, tmp_path, cut, bdf):
    path = str(tmp_path / ('x.bdf' if bdf else 'x.edf'))
    sig = rng.randn(1024)
    edf.write_edf(path, [sig], ['A1'], [256.0], bdf=bdf)   # 4 records.
    with open(path, 'rb') as f:
        blob = f.read()
    with open(path, 'wb') as f:
        f.write(blob[:len(blob) - cut])
    parsed = edf.read_edf(path)
    assert_same_read(parsed, jax_edf.read_edf(path))
    record_bytes = 256 * (3 if bdf else 2)
    assert parsed['num_records'] == (4 * record_bytes - cut) // record_bytes
    np.testing.assert_allclose(parsed['signal_list'][0],
                               sig[:256 * parsed['num_records']], atol=1e-2)


def test_too_short_and_bad_counts_raise(tmp_path):
    path = str(tmp_path / 'short.edf')
    with open(path, 'wb') as f:
        f.write(b'0' * 100)
    for module in (edf, jax_edf):
        with pytest.raises(ValueError, match='too short'):
            module.read_edf(path)


# -- tests/test_fuzz_codecs.py's EDF fuzz, port against JAX -----------------

def _garbage_blobs(rng, max_len=4096):
    for _ in range(N_GARBAGE):
        n = int(rng.randint(0, max_len))
        yield rng.randint(0, 256, size=n, dtype=np.uint8).tobytes()


def _mutate(rng, data: bytes) -> bytes:
    buf = bytearray(data)
    kind = rng.randint(3)
    if kind == 0 and buf:
        for _ in range(int(rng.randint(1, 8))):
            buf[int(rng.randint(len(buf)))] = int(rng.randint(256))
    elif kind == 1:
        buf = buf[:int(rng.randint(len(buf) + 1))]
    else:
        pos = int(rng.randint(len(buf) + 1))
        junk = rng.randint(0, 256, size=int(rng.randint(1, 64)),
                           dtype=np.uint8).tobytes()
        buf = buf[:pos] + junk + buf[pos:]
    return bytes(buf)


def test_fuzz_garbage(tmp_path):
    rng = np.random.RandomState(4)
    path = str(tmp_path / 'fuzz.edf')
    for blob in _garbage_blobs(rng):
        with open(path, 'wb') as f:
            f.write(blob)
        assert_same_outcome(edf.read_edf, jax_edf.read_edf, path)


@pytest.mark.parametrize('bdf', [False, True], ids=['edf', 'bdf'])
def test_fuzz_mutated_valid(tmp_path, bdf):
    rng = np.random.RandomState(5)
    valid = str(tmp_path / 'valid.edf')
    edf.write_edf(valid, [rng.randn(256) for _ in range(4)],
                  labels=['c%d' % i for i in range(4)],
                  sample_rates=[64.0] * 4, bdf=bdf)
    with open(valid, 'rb') as f:
        base = f.read()
    path = str(tmp_path / 'mut.edf')
    for _ in range(N_MUTANTS):
        with open(path, 'wb') as f:
            f.write(_mutate(rng, base))
        assert_same_outcome(edf.read_edf, jax_edf.read_edf, path)
        assert_same_outcome(edf.parse_edf_file, jax_edf.parse_edf_file,
                            path)


# -- the ingest's EDF reader --------------------------------------------------

def test_edf_brain_data_file_matches_jax(rng, tmp_path):
    edf.write_edf(str(tmp_path / 'subj.edf'), [rng.randn(640),
                                               rng.randn(640)],
                  ['A1', 'A2'], [64.0, 64.0])
    readers = []
    for module in (ingest, jax_ingest):
        reader = module.EdfBrainDataFile('subj')
        reader.load_all_data(str(tmp_path))
        readers.append(reader)
    got, want = readers
    assert got.signal_names == want.signal_names == ['A1', 'A2']
    for name in ('A1', 'A2'):
        np.testing.assert_array_equal(got.signal_values(name),
                                      want.signal_values(name))
        assert got.signal_fs(name) == want.signal_fs(name) == 64.0
    assert got.find_channel_index('A2') == want.find_channel_index('A2') == 1
    assert got.find_channel_index('missing') is None
    for reader in readers:
        with pytest.raises(ValueError, match='not in EDF signals'):
            reader.signal_values('missing')
        with pytest.raises(ValueError, match='not in EDF signals'):
            reader.signal_fs('missing')
    assert str(got) == "EdfBrainDataFile('subj')"
    np.testing.assert_array_equal(
        ingest.parse_edf_file(str(tmp_path / 'subj.edf'))['signals'],
        jax_ingest.parse_edf_file(str(tmp_path / 'subj.edf'))['signals'])


def test_edf_brain_data_file_errors(tmp_path):
    for module in (ingest, jax_ingest):
        reader = module.EdfBrainDataFile('nothere')
        with pytest.raises(IOError, match='Data_dir does not exist'):
            reader.load_all_data(str(tmp_path / 'nodir'))
        with pytest.raises(IOError, match='Can not open'):
            reader.load_all_data(str(tmp_path))
        with pytest.raises(ValueError, match='Can not find labels'):
            reader.find_channel_index('A1')
        # A file-backed EDF needs its directory.
        trial = module.BrainTrial('t')
        with pytest.raises(IOError, match='directory is required'):
            trial.load_brain_data(None, reader)


def test_brain_trial_loads_an_edf_like_jax(rng, tmp_path):
    edf.write_edf(str(tmp_path / 'rec.edf'),
                  [rng.randn(512), rng.randn(512)], ['C3', 'TRIG'],
                  [128.0, 128.0])
    trials = []
    for module in (ingest, jax_ingest):
        trial = module.BrainTrial('rec')
        trial.load_brain_data(str(tmp_path),
                              module.EdfBrainDataFile('rec.edf'))
        trials.append(trial)
    got, want = trials
    assert list(got.brain_data) == list(want.brain_data) == ['C3', 'TRIG']
    for name in got.brain_data:
        np.testing.assert_array_equal(got.brain_data[name].signal,
                                      want.brain_data[name].signal)
        assert got.brain_data[name].sr == want.brain_data[name].sr
    assert got.summary_string() == want.summary_string()


def test_local_copy(tmp_path):
    src = tmp_path / 'remote.edf'
    src.write_bytes(b'edf bytes')
    with ingest.LocalCopy(str(src)) as local:
        assert local != str(src) and local.endswith('.edf')
        with open(local, 'rb') as f:
            assert f.read() == b'edf bytes'
    assert not os.path.exists(local)
    with jax_ingest.LocalCopy(str(src)) as local:
        assert local.endswith('.edf')
