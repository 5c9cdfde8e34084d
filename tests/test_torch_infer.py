"""The port's infer driver (cli/infer.py) vs the JAX package's.

The records and the model of tests/test_infer.py (a linear model trained
by the JAX driver on one file that attends speaker 1 throughout; a test
file whose attention switches at its midpoint) go through both drivers'
window sweeps on the CPU. The accuracy dicts must be equal for ``wta``
and ``stepped`` (the frame scores agree to float32 rounding and only
cross-window means are compared), and within one window's share
(1 / windows) for ``ssd``, whose probabilities agree to about 1e-7
(tests/test_torch_attention_decoder.py) but may sit on either side of
0.5. The CSV must be the same byte for byte. A DNN and a deep CCA
trained by the JAX driver on the same file sweep as they do there.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from telluride_decoding_tpu.cli import decoding as jax_decoding
from telluride_decoding_tpu.cli import infer as jax_infer
from telluride_decoding_tpu.data import records
from telluride_decoding_torch.cli import infer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNELS = 4
LABELS = ('loudness', 'loudness2')


def write_two_speaker_data(rng, d, w_true):
    """tests/test_infer.py's corpus: train01 attends speaker 1 throughout,
    test01 switches to speaker 2 at its midpoint."""
    os.makedirs(d, exist_ok=True)

    def build(n, labels):
        eeg = rng.randn(n, CHANNELS).astype(np.float32)
        matched = (eeg @ w_true).astype(np.float32)
        loud1 = np.where(labels == 0, matched,
                         rng.randn(n, 1).astype(np.float32))
        loud2 = np.where(labels == 1, matched,
                         rng.randn(n, 1).astype(np.float32))
        return {'eeg': eeg, 'loudness': loud1, 'loudness2': loud2,
                'attend': labels.astype(np.float32)}

    records.convert_data_to_tfrecords(
        build(3000, np.zeros((3000, 1))), os.path.join(d, 'train01.tfrecords'))
    test_labels = np.zeros((2000, 1))
    test_labels[1000:] = 1.0
    records.convert_data_to_tfrecords(
        build(2000, test_labels), os.path.join(d, 'test01.tfrecords'))


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('infer')
    rng = np.random.RandomState(42)
    tf_dir = str(tmp / 'records')
    write_two_speaker_data(rng, tf_dir,
                           rng.randn(CHANNELS, 1).astype(np.float32))
    model_dir = str(tmp / 'linear_model')
    jax_decoding.run_decoding_experiment(
        jax_decoding.DecodingOptions().set_from_dict(dict(
            data='tfrecords', tfexample_dir=tf_dir, input_field='eeg',
            output_field='loudness', attended_field='attend',
            frame_rate=100.0, pre_context=0, post_context=0,
            dnn_regressor='linear', regularization_lambda=1e-4,
            batch_size=200, shuffle_buffer_size=0,
            train_file_pattern='train', validate_file_pattern='train',
            test_file_pattern='train', summary_dir=str(tmp / 'summary'),
            saved_model_dir=model_dir, correlation_reducer='lda')))
    return tf_dir, model_dir


def sweep(module, setup, reduction, decision, window_list, **kwargs):
    tf_dir, model_dir = setup
    if module is infer:
        kwargs['device'] = 'cpu'
    return module.run_reduction_test(
        model_dir, tf_dir, ['train'], ['test'], reduction, decision,
        *LABELS, window_list=window_list, **kwargs)


@pytest.mark.parametrize('reduction,decision', [('lda', 'wta'),
                                                ('first', 'stepped'),
                                                ('mean', 'wta')])
def test_reduction_test_matches_jax(setup, reduction, decision):
    sizes = [10, 100, 200, 400]
    got = sweep(infer, setup, reduction, decision, sizes)
    assert got == sweep(jax_infer, setup, reduction, decision, sizes)
    if reduction == 'lda':
        # The reference gate (test/infer_test.py:171-176).
        assert got[100] > 0.95 and got[200] > 0.95


def test_ssd_sweep_matches_jax(setup):
    sizes = [200, 400]
    got = sweep(infer, setup, 'lda', 'ssd', sizes)
    want = sweep(jax_infer, setup, 'lda', 'ssd', sizes)
    assert list(got) == sizes
    for size in sizes:
        windows = (2000 - size) // (size // 2) + 1
        assert abs(got[size] - want[size]) <= 1.0 / windows + 1e-12


def test_ssd_sweep_decides_every_size_in_one_sequence(setup, monkeypatch):
    """For ssd the sweep hands every window size's decoder to one
    attention_sequences call of the state-space decoder (one S1 sequence
    launch on the card) and decides no window alone; wta never calls
    it."""
    from telluride_decoding_torch.decide import attention_decoder as ad
    calls = []
    real = ad.StateSpaceAttentionDecoder.attention_sequences

    def spy(cls, decoders, r1s, r2s):
        calls.append([dec.k_w for dec in decoders])
        return real(decoders, r1s, r2s)

    def alone(self, r1, r2):
        raise AssertionError('a window decided on its own')
    monkeypatch.setattr(ad.StateSpaceAttentionDecoder, 'attention_sequences',
                        classmethod(spy))
    monkeypatch.setattr(ad.StateSpaceAttentionDecoder, 'attention', alone)
    sweep(infer, setup, 'lda', 'ssd', [400, 1000])
    assert calls == [[14, 14]]
    sweep(infer, setup, 'lda', 'wta', [400, 1000])
    assert len(calls) == 1


def test_csv_is_byte_identical(setup, tmp_path):
    paths = [str(tmp_path / name) for name in ('port.csv', 'jax.csv')]
    for module, path in zip((infer, jax_infer), paths):
        sweep(module, setup, 'lda', 'stepped', [100, 200],
              save_results_csv=path)
    with open(paths[0], 'rb') as got, open(paths[1], 'rb') as want:
        data = got.read()
        assert data == want.read()
    assert data.startswith(b'Window size,Accuracy\n100,')


def test_comparison_test_matches_jax(setup, tmp_path):
    tf_dir, model_dir = setup
    common = (model_dir, tf_dir, ['train'], ['test'], *LABELS)
    kwargs = dict(reduction_list=['first', 'lda'],
                  decoder_list=['wta', 'stepped'], window_list=[100])
    plot_dir = str(tmp_path / 'plots')
    got = infer.run_comparison_test(*common, plot_dir, device='cpu',
                                    **kwargs)
    want = jax_infer.run_comparison_test(*common, None, **kwargs)
    assert got == want and list(got) == list(want)
    for name in ('test_results-comparison.png',
                 'test_results_lda_stepped_00100.png',
                 'test_results_first_wta.png'):
        assert os.path.exists(os.path.join(plot_dir, name)), name


def test_main_takes_jax_spelled_flags(setup, tmp_path, capsys):
    tf_dir, model_dir = setup
    got_csv, want_csv = str(tmp_path / 'got.csv'), str(tmp_path / 'want.csv')
    assert infer.main(['--tf_dir=' + tf_dir, '--model_dir', model_dir,
                       '--train_files=train', '--test_files', 'test',
                       '--audio_label=loudness', '--reduction=first',
                       '--decoder', 'wta', '--nocomparison_test',
                       '--frame_rate=100', '--save_results_csv=' + got_csv,
                       '--device', 'cpu']) == 0
    assert 'Infer classification result with first and wta: [' in \
        capsys.readouterr().out
    jax_infer.run_reduction_test(model_dir, tf_dir, ['train'], ['test'],
                                 'first', 'wta', *LABELS,
                                 save_results_csv=want_csv)
    with open(got_csv) as got, open(want_csv) as want:
        assert got.read() == want.read()


@pytest.mark.parametrize('argv', [['--model_dir', '/nonexistent'],
                                  ['--tf_dir', '/nonexistent'],
                                  ['--decoder', 'bogus']])
def test_main_rejects_bad_flags(setup, argv):
    if argv[0] == '--tf_dir':
        argv = argv + ['--model_dir', setup[1]]
    with pytest.raises(SystemExit):
        infer.main(argv + ['--device', 'cpu'])


def test_find_first_segment():
    assert infer.find_first_segment(np.array([0.0, 0, 0, 1, 1, 0])) == 3
    assert infer.find_first_segment([1, 1, 0]) == 2
    assert infer.find_first_segment(np.zeros(5)) == 0
    with pytest.raises(TypeError):
        infer.find_first_segment('nope')
    with pytest.raises(TypeError):
        infer.find_first_segment(np.zeros((3, 2)))


def test_calculate_time_axis():
    for data in (4, [1, 2, 3, 4], np.zeros(4)):
        np.testing.assert_array_equal(
            infer.calculate_time_axis(data, 100, 200, 100.0),
            jax_infer.calculate_time_axis(data, 100, 200, 100.0))
    np.testing.assert_allclose(
        infer.calculate_time_axis(4, 100, 200, 100.0) * 60 * 100,
        [100, 200, 300, 400])
    with pytest.raises(TypeError):
        infer.calculate_time_axis('x', 1, 1, 1.0)


def test_load_model_requires_decoder_params(setup, tmp_path):
    with pytest.raises(Exception):
        infer.load_model(str(tmp_path / 'nonexistent_linear'), 'lda', 'cpu')
    bare = tmp_path / 'bare'
    bare.mkdir()
    for name in ('model.json', 'weights.npz'):
        with open(os.path.join(setup[1], name), 'rb') as f:
            (bare / name).write_bytes(f.read())
    with pytest.raises(IOError, match='decoder model parameters'):
        infer.load_model(str(bare), 'lda', 'cpu')


def test_infer_imports_no_jax():
    code = ('import sys\n'
            'import telluride_decoding_torch.cli.infer\n'
            'bad = sorted(n for n in sys.modules if n.split(".")[0] in '
            '("jax", "jaxlib", "telluride_decoding_tpu", "absl"))\n'
            'assert not bad, bad\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout


@pytest.mark.parametrize('kind', ['fullyconnected', 'dcca'])
def test_sgd_model_dirs_sweep_as_in_jax(setup, tmp_path, kind):
    """A DNN and a deep CCA trained by the JAX driver on the same file
    load through the registry and sweep as in the JAX driver (a DCCA's
    lda frame scores through K1's plain version on its towers'
    outputs)."""
    tf_dir = setup[0]
    model_dir = str(tmp_path / kind)
    values = dict(
        data='tfrecords', tfexample_dir=tf_dir, input_field='eeg',
        output_field='loudness', attended_field='attend', frame_rate=100.0,
        pre_context=0, post_context=0, dnn_regressor=kind,
        hidden_units='8', learning_rate=1e-2, epoch_count=10,
        regularization_lambda=1e-3, batch_size=200, shuffle_buffer_size=0,
        train_file_pattern='train', validate_file_pattern='train',
        test_file_pattern='train', summary_dir=str(tmp_path / 'summary'),
        saved_model_dir=model_dir, correlation_reducer='lda')
    if kind == 'dcca':
        values.update(input2_field='loudness', cca_dimensions=1)
    jax_decoding.run_decoding_experiment(
        jax_decoding.DecodingOptions().set_from_dict(values))
    sizes = [100, 200, 400]
    got, want = (module.run_reduction_test(
        model_dir, tf_dir, ['train'], ['test'], 'lda', 'wta', *LABELS,
        window_list=sizes, **extra)
        for module, extra in ((infer, {'device': 'cpu'}), (jax_infer, {})))
    assert got == want
    assert got[200] > 0.9
