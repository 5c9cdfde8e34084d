"""Telluride4 and jens_impaired ingest and the downloader of the PyTorch
port vs the JAX package.

The caches are made from a seed (build_telluride4_mat and
build_impaired_subject of tools/raw_recordings.py, at small sizes). Both
packages' ingests of the same cache must write byte-identical TFRecords
and the same README.txt apart from the ``Using:`` line (sys.argv) and the
output directory. The downloads of tests/test_mock_downloads.py run for
all four corpora through file:// URLs and stub openers; every test here
runs with outside connections refused (``no_network``).
"""

import io
import os
import socket
import tarfile
import urllib.request
import zipfile

import numpy as np
import pytest
import scipy.io as spio
import scipy.io.wavfile
from absl.testing import flagsaver

from telluride_decoding_tpu.cli import regression_data as jax_rd
from telluride_decoding_tpu.data import records as jax_records
from telluride_decoding_tpu.io import edf as jax_edf
from telluride_decoding_torch.cli import regression_data
from telluride_decoding_torch.data import records
from tools import raw_recordings

# The corpora cut to size: Telluride4 trials of 200 frames at 6
# channels; jens_impaired trials of 60 samples at 3 channels.
SMALL_T4 = dict(trials=32, tracks=4, channels=6, frames=200)
SMALL_IMPAIRED = dict(channels=3, fs=512, trials=48, dual=32, frames=60,
                      gap=20)


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """Refuses any connection that is not to this host."""
    real_connect = socket.socket.connect

    def connect(self, address):
        host = address[0] if isinstance(address, tuple) else address
        if isinstance(host, str) and host not in ('127.0.0.1', '::1',
                                                  'localhost') \
                and self.family in (socket.AF_INET, socket.AF_INET6):
            raise AssertionError('a test tried to reach %r' % (address,))
        return real_connect(self, address)
    monkeypatch.setattr(socket.socket, 'connect', connect)
    monkeypatch.setattr(socket, 'getaddrinfo', lambda *a, **k: (_ for _ in (
        )).throw(AssertionError('a test tried to resolve %r' % (a,))))


@pytest.fixture
def tmpdir_env(tmp_path, monkeypatch):
    """$TMPDIR of this test, where both packages stage archives (the
    JAX package read it when it was imported, so its copy is set
    too)."""
    staging = tmp_path / 'tmpdir'
    staging.mkdir()
    monkeypatch.setenv('TMPDIR', str(staging))
    monkeypatch.setattr(jax_rd, '_tmp_dir', str(staging))
    return staging


def tfrecord_files(tf_dir):
    return sorted(os.path.relpath(os.path.join(root, f), tf_dir)
                  for root, _, files in os.walk(tf_dir)
                  for f in files if f.endswith('.tfrecords'))


def assert_same_ingest(port_dir, jax_dir):
    """Byte-identical TFRecords, and README.txt files equal apart from
    sys.argv and the directory that holds each side's output (and, in
    the download tests, its cache)."""
    files = tfrecord_files(port_dir)
    assert files and files == tfrecord_files(jax_dir)
    for name in files:
        with open(os.path.join(port_dir, name), 'rb') as f, \
                open(os.path.join(jax_dir, name), 'rb') as g:
            assert f.read() == g.read(), name
    readmes = sorted(os.path.relpath(os.path.join(root, f), port_dir)
                     for root, _, names in os.walk(port_dir)
                     for f in names if f == 'README.txt')
    assert readmes
    for name in readmes:
        texts = []
        for d in (port_dir, jax_dir):
            with open(os.path.join(d, name)) as f:
                texts.append([line.replace(d, '<tf_dir>').replace(
                    os.path.dirname(d), '<root>') for line in f
                    if not line.startswith('Using:')])
        assert texts[0] == texts[1]
    return files


def jax_main(argv):
    """The JAX driver with the flags of ``argv`` (--name=value), every
    other flag of its own at its default, restored afterwards."""
    values = dict(internet=None, cache_dir=None, tf_output_dir=None,
                  desired_frame_rate=0.0, force=False, type='telluride4')
    for arg in argv:
        name, value = arg[2:].split('=', 1)
        values[name] = float(value) if name == 'desired_frame_rate' \
            else value
    jax_rd.FLAGS(['prog'])
    with flagsaver.flagsaver(**values):
        jax_rd.main(['prog'])


def port_main(argv):
    return regression_data.main(argv + ['--device', 'cpu'])


# -- Telluride4 --------------------------------------------------------------

def test_telluride4_ingest_is_byte_identical(tmp_path):
    cache = tmp_path / 'cache'
    raw_recordings.build_telluride4_mat(str(cache / 'Telluride2015.mat'),
                                        **SMALL_T4)
    jax_rd.RegressionDataTelluride4().ingest_data(str(cache),
                                                  str(tmp_path / 'jax'), 64)
    port = regression_data.RegressionDataTelluride4(device='cpu')
    assert port.is_data_local(str(cache))
    assert not port.is_data_ingested(str(tmp_path / 'port'))
    port.ingest_data(str(cache), str(tmp_path / 'port'), 64)
    assert port.is_data_ingested(str(tmp_path / 'port'))
    files = assert_same_ingest(str(tmp_path / 'port'), str(tmp_path / 'jax'))
    assert len(files) == 32
    data = records.read_tfrecords(str(tmp_path / 'port' /
                                      'trial_01.tfrecords'))
    assert set(data) == {'eeg', 'intensity', 'ones', 'attended_speaker'}
    assert data['eeg'].shape == (200, 6)


@pytest.mark.parametrize('eeg_trials,tracks', [(31, 4), (32, 3)])
def test_telluride4_rejects_bad_shapes(tmp_path, rng, eeg_trials, tracks):
    eeg = np.empty((eeg_trials,), object)
    wav = np.empty((tracks,), object)
    for i in range(eeg_trials):
        eeg[i] = rng.randn(50, 2)
    for i in range(tracks):
        wav[i] = rng.rand(50, 1)
    spio.savemat(str(tmp_path / 'Telluride2015.mat'),
                 {'data': {'eeg': eeg, 'wav': wav}})
    for obj in (regression_data.RegressionDataTelluride4(device='cpu'),
                jax_rd.RegressionDataTelluride4()):
        with pytest.raises(ValueError, match='Incorrect shapes'):
            obj.ingest_data(str(tmp_path), str(tmp_path / 'tf'), 64)


# -- jens_impaired -----------------------------------------------------------

@pytest.fixture
def impaired(tmp_path):
    cache = tmp_path / 'cache'
    raw_recordings.build_impaired_subject(str(cache), **SMALL_IMPAIRED)
    return str(cache)


def test_jens_impaired_ingest_is_byte_identical(impaired, tmp_path):
    jax_rd.RegressionDataJensImpaired().ingest_data(impaired,
                                                    str(tmp_path / 'jax'), 64)
    port = regression_data.RegressionDataJensImpaired(device='cpu')
    assert port.is_data_local(impaired)
    port.ingest_data(impaired, str(tmp_path / 'port'), 64)
    files = assert_same_ingest(str(tmp_path / 'port'), str(tmp_path / 'jax'))
    assert len([f for f in files if 'dual_speaker' in f]) == 32
    assert len([f for f in files if 'single_speaker' in f]) == 16
    data = records.read_tfrecords(str(
        tmp_path / 'port' / 'subject_01' /
        'trial_01_dual_speaker.tfrecords'))
    assert set(data) == {'eeg', 'attended_intensity', 'unattended_intensity'}
    assert data['eeg'].shape == (60, 3)
    # A rerun skips the subject whose README.txt is there.
    mtime = os.path.getmtime(str(tmp_path / 'port' / 'subject_01' /
                                 files[0].split('/')[1]))
    port.ingest_data(impaired, str(tmp_path / 'port'), 64)
    assert os.path.getmtime(str(tmp_path / 'port' / 'subject_01' /
                                files[0].split('/')[1])) == mtime


def test_jens_impaired_readme_rate_is_not_the_records_rate(impaired,
                                                          tmp_path):
    """The reference fault the port copies (ROADMAP.md section 3): the
    records hold the BDF's 512 Hz samples unresampled, and README.txt
    states their duration at the desired frame rate, 64 Hz."""
    jax_rd.RegressionDataJensImpaired().ingest_data(impaired,
                                                    str(tmp_path / 'jax'), 64)
    regression_data.RegressionDataJensImpaired(device='cpu').ingest_data(
        impaired, str(tmp_path / 'port'), 64)
    bdf = os.path.join(impaired, 'sub-001', 'eeg',
                       'sub-001_task-selectiveattention_eeg.bdf')
    assert list(jax_edf.read_edf(bdf)['sample_rates']) == [512.0] * 3
    for tf_dir in (tmp_path / 'port', tmp_path / 'jax'):
        readme = (tf_dir / 'subject_01' / 'README.txt').read_text()
        assert 'With a output frame rate of 64Hz' in readme
        assert ': 60 records (0.9375 seconds)' in readme   # 60 / 64.
        assert '(0.1171875 seconds)' not in readme         # 60 / 512.


def _events(cache):
    return os.path.join(cache, 'sub-001', 'eeg',
                        'sub-001_task-selectiveattention_events.tsv')


def test_jens_impaired_rejects_bad_event_counts(impaired, tmp_path):
    with open(_events(impaired)) as f:
        lines = f.read().strip().split('\n')
    with open(_events(impaired), 'w') as f:
        f.write('\n'.join(lines[:-5]))
    for obj in (regression_data.RegressionDataJensImpaired(device='cpu'),
                jax_rd.RegressionDataJensImpaired()):
        with pytest.raises(ValueError, match='Incorrect event counts'):
            obj.ingest_data(impaired, str(tmp_path / 'tf'), 64)


def test_jens_impaired_rejects_a_masker_before_its_target(impaired,
                                                          tmp_path):
    with open(_events(impaired)) as f:
        lines = f.read().split('\n')
    kind, sample, stim = lines[2].split('\t')
    assert kind == 'maskeronset' and stim == 'stim/m001.wav'
    lines[2] = '\t'.join([kind, str(int(sample) - 30), stim])
    with open(_events(impaired), 'w') as f:
        f.write('\n'.join(lines))
    for obj in (regression_data.RegressionDataJensImpaired(device='cpu'),
                jax_rd.RegressionDataJensImpaired()):
        with pytest.raises(ValueError, match='BEFORE the target'):
            obj.ingest_data(impaired, str(tmp_path / 'tf'), 64)


def test_jens_impaired_rejects_a_masker_of_another_length(impaired,
                                                          tmp_path):
    path = os.path.join(impaired, 'derivatives', 'stimuli', 'sub001',
                        'masker', 'm002.mat')
    spio.savemat(path, {'dat': {'feat': np.ones(61)}})
    for obj in (regression_data.RegressionDataJensImpaired(device='cpu'),
                jax_rd.RegressionDataJensImpaired()):
        with pytest.raises(ValueError, match='length mismatch'):
            obj.ingest_data(impaired, str(tmp_path / 'tf'), 64)


def test_subject_24_reads_its_second_events_file(tmp_path):
    """Subject 24 (the 24th subject directory) has its events in two
    files; the second, _run-2_events.tsv, is read after the first. The
    23 subjects before it are marked ingested, so both drivers skip
    them."""
    cache = tmp_path / 'cache'
    raw_recordings.build_impaired_subject(str(cache), subject=24,
                                          split_events=True,
                                          **SMALL_IMPAIRED)
    assert os.path.exists(str(cache / 'sub-024' / 'eeg' /
                              'sub-024_task-selectiveattention_run-2_'
                              'events.tsv'))
    for s in range(1, 24):
        (cache / ('sub-%03d' % s)).mkdir()
        for side in ('port', 'jax'):
            done = tmp_path / side / ('subject_%02d' % s)
            done.mkdir(parents=True)
            (done / 'README.txt').write_text('ingested\n')
    jax_rd.RegressionDataJensImpaired().ingest_data(str(cache),
                                                    str(tmp_path / 'jax'), 64)
    regression_data.RegressionDataJensImpaired(device='cpu').ingest_data(
        str(cache), str(tmp_path / 'port'), 64)
    files = assert_same_ingest(str(tmp_path / 'port'), str(tmp_path / 'jax'))
    assert len(files) == 48 and files[0].startswith('subject_24/')
    starts, maskers = regression_data.RegressionDataJensImpaired \
        .subject_events(str(cache), 'sub-024', 23)
    assert len(starts) == 48 and len(maskers) == 32
    # Another subject's position does not read the second file.
    starts, maskers = regression_data.RegressionDataJensImpaired \
        .subject_events(str(cache), 'sub-024', 0)
    assert len(starts) + len(maskers) == 40


def test_events_tsv_reads_as_pandas_does(impaired):
    pd = pytest.importorskip('pandas')
    rows = regression_data._read_events(_events(impaired))
    frame = pd.read_csv(_events(impaired), sep='\t')
    assert [r['trigger_type'] for r in rows] == list(frame['trigger_type'])
    assert [regression_data._sample(r['sample']) for r in rows] == \
        list(frame['sample'])


# -- downloads: tests/test_mock_downloads.py on both packages ----------------

def test_telluride4_download_and_ingest(tmp_path, tmpdir_env):
    src = tmp_path / 'stage' / 'Telluride2015.mat'
    raw_recordings.build_telluride4_mat(str(src), **SMALL_T4)
    outputs = {}
    for side, run in (('port', port_main), ('jax', jax_main)):
        cache, tf_dir = str(tmp_path / side / 'cache'), str(tmp_path / side
                                                            / 'tf')
        rc = run(['--type=telluride4', '--internet=' + src.as_uri(),
                  '--cache_dir=' + cache, '--tf_output_dir=' + tf_dir,
                  '--desired_frame_rate=64'])
        assert rc in (0, None)
        assert os.path.exists(os.path.join(cache, 'Telluride2015.mat'))
        with open(os.path.join(cache, 'README.txt')) as f:
            assert f.read().startswith('These files were downloaded\nFrom '
                                       + src.as_uri())
        outputs[side] = tf_dir
    assert len(assert_same_ingest(outputs['port'], outputs['jax'])) == 32


def test_jens_memory_download_and_ingest(tmp_path, rng, tmpdir_env):
    stage = tmp_path / 'stage'
    stage.mkdir()
    for sid in range(22):
        trials = np.empty((2,), object)
        for t in range(2):
            trials[t] = rng.randn(70, 64)
        spio.savemat(str(stage / ('subject_%02d.mat' % sid)),
                     {'data': {'fsample': 128.0, 'trial': trials}})
    archive = tmp_path / 'DATA.zip'
    with zipfile.ZipFile(str(archive), 'w') as zf:
        for f in sorted(os.listdir(str(stage))):
            zf.write(str(stage / f), f)
    outputs = {}
    for side, run in (('port', port_main), ('jax', jax_main)):
        cache, tf_dir = str(tmp_path / side / 'cache'), str(tmp_path / side
                                                            / 'tf')
        run(['--type=jens_memory', '--internet=' + archive.as_uri(),
             '--cache_dir=' + cache, '--tf_output_dir=' + tf_dir])
        assert len([f for f in os.listdir(cache) if f.endswith('.mat')]) == 22
        outputs[side] = tf_dir
    files = tfrecord_files(outputs['port'])
    assert files == tfrecord_files(outputs['jax']) and len(files) == 44
    for name in files:
        got = records.read_tfrecords(os.path.join(outputs['port'], name))
        want = jax_records.read_tfrecords(os.path.join(outputs['jax'], name))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0)


def test_jens_impaired_download_untar_and_ingest(tmp_path, tmpdir_env):
    stage = tmp_path / 'stage' / 'ds-eeg-snhl'
    raw_recordings.build_impaired_subject(str(stage), **SMALL_IMPAIRED)
    archive = tmp_path / 'ds-eeg-snhl.tar'
    with tarfile.open(str(archive), 'w') as tf:
        tf.add(str(stage), arcname='ds-eeg-snhl')
    outputs = {}
    for side, run in (('port', port_main), ('jax', jax_main)):
        cache, tf_dir = str(tmp_path / side / 'cache'), str(tmp_path / side
                                                            / 'tf')
        # A leftover of an earlier attempt is replaced by the fresh one.
        os.makedirs(os.path.join(cache, 'derivatives', 'stale'))
        run(['--type=jens_impaired', '--internet=' + archive.as_uri(),
             '--cache_dir=' + cache, '--tf_output_dir=' + tf_dir])
        assert os.path.isdir(os.path.join(cache, 'sub-001'))
        assert not os.path.exists(os.path.join(cache, 'ds-eeg-snhl'))
        assert not os.path.exists(os.path.join(cache, 'derivatives',
                                               'stale'))
        assert os.path.exists(os.path.join(str(tmpdir_env),
                                           'ds-eeg-snhl.tar'))
        outputs[side] = tf_dir
    files = assert_same_ingest(outputs['port'], outputs['jax'])
    assert len([f for f in files if 'dual_speaker' in f]) == 32


def test_kuleuven_download_unzip_and_ingest(tmp_path, rng, tmpdir_env):
    stage = tmp_path / 'stage'
    (stage / 'stimuli').mkdir(parents=True)
    names = ['part1_track1', 'part1_track2']
    for name in names:
        scipy.io.wavfile.write(str(stage / 'stimuli' / (name + '.wav')),
                               8000, (3000 * rng.randn(16000)).astype(
                                   np.int16))
    for sid in range(16):
        trials = np.empty((2,), object)
        for t in range(2):
            trials[t] = {'attended_ear': 'L' if t % 2 == 0 else 'R',
                         'stimuli': np.array(names, dtype=object),
                         'RawData': {'EegData': rng.randn(256, 8)},
                         'FileHeader': {'SampleRate': 128.0}}
        spio.savemat(str(stage / ('S%d.mat' % (sid + 1))),
                     {'preproc_trials': trials})
    archive = tmp_path / 'kuleuven.zip'
    with zipfile.ZipFile(str(archive), 'w') as zf:
        for root, _, files in os.walk(str(stage)):
            for f in files:
                full = os.path.join(root, f)
                zf.write(full, os.path.relpath(full, str(stage)))
    outputs = {}
    for side, run in (('port', port_main), ('jax', jax_main)):
        cache, tf_dir = str(tmp_path / side / 'cache'), str(tmp_path / side
                                                            / 'tf')
        run(['--type=kuleuven', '--internet=' + archive.as_uri(),
             '--cache_dir=' + cache, '--tf_output_dir=' + tf_dir,
             '--desired_frame_rate=32'])
        outputs[side] = tf_dir
    files = tfrecord_files(outputs['port'])
    assert files == tfrecord_files(outputs['jax']) and len(files) == 32
    data = records.read_tfrecords(os.path.join(outputs['port'], files[0]))
    assert data['eeg'].shape == (64, 8) and data['intensity'].shape == (64, 1)


def test_default_urls_are_the_jax_ones():
    assert list(regression_data.locations) == list(jax_rd.locations)
    for name, loc in regression_data.locations.items():
        want = jax_rd.locations[name]
        assert loc.internet == want.internet
        assert (loc.cache_dir, loc.tf_dir, loc.desired_frame_rate) == \
            (want.cache_dir, want.tf_dir, want.desired_frame_rate)
        assert loc.data_type.__name__ == want.data_type.__name__
    assert regression_data.parse_args([]).type == 'telluride4'


def test_kuleuven_default_url_prints_instructions(tmp_path, capsys):
    """The published KULeuven URL is no .zip: main prints the manual
    steps and returns 1 without fetching anything."""
    assert port_main(['--type', 'kuleuven', '--cache_dir',
                      str(tmp_path / 'cache'), '--tf_output_dir',
                      str(tmp_path / 'tf')]) == 1
    captured = capsys.readouterr()
    assert 'preprocess_data' in captured.out
    assert 'aborting' in captured.err
    assert not os.path.exists(str(tmp_path / 'tf'))


def test_jens_impaired_unfetchable_prints_instructions(tmp_path, capsys,
                                                       tmpdir_env):
    for obj in (regression_data.RegressionDataJensImpaired(device='cpu'),
                jax_rd.RegressionDataJensImpaired()):
        assert not obj.download_data((tmp_path / 'missing.tar').as_uri(),
                                     str(tmp_path / 'cache'))
        assert 'tar xvf' in capsys.readouterr().out
    assert not os.path.exists(str(tmp_path / 'cache'))


@pytest.mark.parametrize('body,ok', [
    (b'\x00\x01payload' * 100, True),
    (b'', False),
    (b'<!DOCTYPE html><html><body>Google Drive - Virus scan warning'
     b'</body></html>', False),
    (b'  <html><body>no form</body></html>', False),
], ids=['payload', 'empty', 'interstitial', 'html'])
def test_download_from_gdrive_matches_jax(tmp_path, body, ok):
    src = tmp_path / 'src.bin'
    src.write_bytes(body)
    for module, name in ((regression_data, 'port.mat'), (jax_rd, 'jax.mat')):
        target = tmp_path / name
        out = module.download_from_gdrive(src.as_uri(), str(target))
        assert (out == str(target)) is ok
        assert target.exists() is ok
        assert not (tmp_path / (name + '.part')).exists()
        if ok:
            assert target.read_bytes() == body
    # An .html target keeps an HTML body.
    page = regression_data.download_from_gdrive(src.as_uri(),
                                                str(tmp_path / 'p.html'))
    assert (page is not None) == bool(body)


def test_download_failure_leaves_nothing(tmp_path):
    for module in (regression_data, jax_rd):
        out = module.download_from_gdrive(
            (tmp_path / 'does-not-exist.bin').as_uri(),
            str(tmp_path / 'out.bin'))
        assert out is None
        assert not (tmp_path / 'out.bin').exists()
        assert not (tmp_path / 'out.bin.part').exists()


class _StubOpener:
    """An opener that answers each URL from a table and records it."""

    def __init__(self, answers):
        self.answers = answers
        self.urls = []

    def open(self, url, timeout=None):
        del timeout
        self.urls.append(url)
        return io.BytesIO(self.answers(url))


FORM_PAGE = (b'<html><body><form id="download-form" '
             b'action="https://drive.usercontent.google.com/download?'
             b'a=1&amp;b=2" method="get">'
             b'<input type="hidden" name="id" value="ABC">'
             b'<input type="hidden" name="export" value="download">'
             b'<input type="hidden" name="confirm" value="t">'
             b'<input type="hidden" name="uuid" value="u-1">'
             b'</form></body></html>')
TOKEN_PAGE = b'<html><a href="/uc?export=download&confirm=Xy_9-z">go</a>'


@pytest.mark.parametrize('page,retry', [
    (FORM_PAGE, 'https://drive.usercontent.google.com/download?a=1&b=2&'
                'id=ABC&export=download&confirm=t&uuid=u-1'),
    (TOKEN_PAGE, 'https://drive.google.com/uc?id=F&confirm=Xy_9-z'),
], ids=['form', 'token'])
def test_confirm_retry_matches_jax(tmp_path, monkeypatch, page, retry):
    """Google Drive's interstitial: the confirm form's action (unescaped,
    its query string extended) or the page's confirm token is fetched
    once, with the cookies kept; both packages ask for the same URLs."""
    url = 'https://drive.google.com/uc?id=F'
    payload = b'MATLAB 5.0 MAT-file' + bytes(200)
    openers = []

    def build_opener(*handlers):
        assert any(isinstance(h, urllib.request.HTTPCookieProcessor)
                   for h in handlers)
        opener = _StubOpener(lambda u: page if u == url else payload)
        openers.append(opener)
        return opener
    monkeypatch.setattr(urllib.request, 'build_opener', build_opener)
    for module, name in ((regression_data, 'port.mat'), (jax_rd, 'jax.mat')):
        target = tmp_path / name
        assert module.download_from_gdrive(url, str(target)) == str(target)
        assert target.read_bytes() == payload
    assert openers[0].urls == openers[1].urls == [url, retry]


def test_confirm_retry_that_fails_again_leaves_nothing(tmp_path, monkeypatch,
                                                       capsys):
    url = 'https://drive.google.com/uc?id=F'
    monkeypatch.setattr(urllib.request, 'build_opener',
                        lambda *h: _StubOpener(lambda u: FORM_PAGE))
    for module in (regression_data, jax_rd):
        assert module.download_from_gdrive(url, str(tmp_path / 'x.mat')) \
            is None
        assert 'HTML page' in capsys.readouterr().out
        assert not os.listdir(str(tmp_path))


def test_no_network_guard_refuses_outside_hosts():
    with pytest.raises(AssertionError, match='tried to resolve'):
        socket.getaddrinfo('example.com', 80)
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        with pytest.raises(AssertionError, match='tried to reach'):
            s.connect(('192.0.2.1', 80))
    finally:
        s.close()
