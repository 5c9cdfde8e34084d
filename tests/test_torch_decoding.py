"""The experiment driver of the PyTorch port vs the JAX driver.

Both drivers run the same options on the same TFRecords (the TRF
simulation of tests/test_decoding.py, written by
``records.convert_data_to_tfrecords``), one after the other into the
same summary and model paths, so results.txt must agree line for line:
the text exactly, the numbers within 1e-4 absolute and d' within 1e-3
relative (float32 moments summed in another order and another LAPACK's
solve, eigh and SVD). decoder_model.json agrees within rtol 1e-4 /
atol 1e-4: its sums per frame, its means and power, the LDA's class
means, slope and intercept. The LDA's discriminant (its first column,
up to sign; a two-class LDA's other columns have a zero eigenvalue and
no set direction) agrees within atol 2e-4: it inverts the within-class
scatter of correlated canonical dimensions, and the JAX package's own
dense and streamed CCA fits of these files, equal in exact arithmetic,
give discriminants 8.3e-5 apart. CCA statistics of
the first order compare up to each canonical dimension's sign, which
eigh and SVD choose freely. Each package's model directory loads in the
other and scores the test file the same within 1e-4.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest

from telluride_decoding_tpu.cli import decoding as jax_decoding
from telluride_decoding_tpu.cli import infer as jax_infer_cli
from telluride_decoding_tpu.data import records
from telluride_decoding_torch.cli import decoding, serve
from telluride_decoding_torch.data import brain_data

import test_decoding

NUMBER_TOL = 1e-4
DPRIME_REL = 1e-3
JSON_TOL = dict(rtol=1e-4, atol=1e-4)
DISCRIMINANT_TOL = dict(rtol=1e-4, atol=2e-4)


@pytest.fixture
def records_dir(tmp_path):
    """The TRF simulation as three TFRecord files."""
    rng = np.random.RandomState(0)
    d = tmp_path / 'records'
    d.mkdir()
    for name in ['trial01', 'trial02', 'trial03']:
        eeg, attended, unattended = test_decoding.simulate_trf(
            rng, num_frames=3000)
        records.convert_data_to_tfrecords(
            {'eeg': eeg, 'intensity': attended, 'unattended': unattended},
            str(d / ('%s.tfrecords' % name)))
    return str(d)


def _options(module, tmp_path, data_dir, **changes):
    values = dict(
        data='tfrecords', tfexample_dir=data_dir, input_field='eeg',
        output_field='intensity', attended_field='', frame_rate=100.0,
        pre_context=0, post_context=test_decoding.IR_FRAMES - 1,
        train_file_pattern='allbut', validate_file_pattern='trial02',
        test_file_pattern='trial02', batch_size=256,
        shuffle_buffer_size=1000, summary_dir=str(tmp_path / 'summary'),
        saved_model_dir=str(tmp_path / 'model'), tensorboard_dir=None,
        correlation_frames=100, correlation_reducer='lda',
        dnn_regressor='linear', regularization_lambda=1e-3)
    if changes.get('dnn_regressor') == 'cca':
        values.update(input2_field='intensity', input2_pre_context=2,
                      input2_post_context=2, cca_dimensions=3)
    values.update(changes)
    return module.DecodingOptions().set_from_dict(values)


def _argv(options):
    """The options as command-line flags, in absl's spellings."""
    argv = []
    for key, value in sorted(vars(options).items()):
        if value is None:
            continue
        if isinstance(value, bool):
            argv.append('--%s%s' % ('' if value else 'no', key))
        else:
            argv.append('--%s=%s' % (key, value))
    return argv + ['--device', 'cpu']


def _read_results(tmp_path):
    """The one results.txt under tmp_path (the PARAMS token nests it
    in directories named by the parameters)."""
    found = [os.path.join(root, 'results.txt')
             for root, _, files in os.walk(str(tmp_path))
             if 'results.txt' in files]
    assert len(found) == 1, found
    with open(found[0]) as f:
        return found[0], f.read()


def _assert_results_match(got_text, want_text):
    got_lines, want_lines = got_text.splitlines(), want_text.splitlines()
    assert [l.split(':')[0] for l in got_lines] == \
        [l.split(':')[0] for l in want_lines]
    for got, want in zip(got_lines, want_lines):
        if not want.startswith('Final_'):
            assert got == want
            continue
        name, want_value = want.split(': ')
        got_value = float(got.split(': ')[1])
        if name.endswith('dprime'):
            assert got_value == pytest.approx(float(want_value),
                                              rel=DPRIME_REL)
        else:
            assert got_value == pytest.approx(float(want_value), rel=0,
                                              abs=NUMBER_TOL)


def _canonical_signs(got_dir, want_dir):
    """Per canonical dimension, +1 or -1 to turn the port's rotation
    into the JAX one (all +1 for a linear model)."""
    with np.load(os.path.join(got_dir, 'weights.npz')) as got, \
            np.load(os.path.join(want_dir, 'weights.npz')) as want:
        if 'rot1' not in want.files:
            return 1.0
        return np.sign(np.sum(got['rot1'] * want['rot1'], axis=0))


def _assert_decoder_json_match(got_dir, want_dir):
    def load(path):
        with open(os.path.join(path, 'decoder_model.json')) as f:
            return json.load(f)
    got, want = load(got_dir), load(want_dir)
    signs = _canonical_signs(got_dir, want_dir)
    got_c, want_c = got['correlation_params'], want['correlation_params']
    count = want_c[0]
    assert got_c[0] == count
    names = ('sum_x', 'sum_y', 'sum_x2', 'sum_y2', 'mean_x', 'mean_y',
             'power')
    for name, g, w in zip(names, got_c[1:], want_c[1:]):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if name in ('sum_x', 'sum_y', 'mean_x', 'mean_y'):
            g = g * signs
        if name.startswith('sum'):
            g, w = g / count, w / count
        np.testing.assert_allclose(g, w, err_msg=name, **JSON_TOL)
    w_real, w_imag, labels, means, slope, intercept = got['lda_params']
    want_l = want['lda_params']
    g, w = np.asarray(w_real)[:, 0], np.asarray(want_l[0])[:, 0]
    flip = np.sign(np.dot(g, w))
    np.testing.assert_allclose(flip * g, w, **DISCRIMINANT_TOL)
    assert np.all(np.asarray(w_imag) == 0) and labels == want_l[2]
    np.testing.assert_allclose(means, want_l[3], **JSON_TOL)
    np.testing.assert_allclose([flip * slope, intercept], want_l[4:],
                               **JSON_TOL)


def _assert_dirs_load_across(got_dir, want_dir, data_dir, options):
    """The port loads the JAX dir and the JAX package the port's; each
    pair of decoders scores the test file the same."""
    test = brain_data.create_brain_dataset(
        'tfrecords', options.input_field, options.output_field,
        frame_rate=options.frame_rate, pre_context=options.pre_context,
        post_context=options.post_context,
        in2_fields=options.input2_field or None,
        in2_pre_context=options.input2_pre_context,
        in2_post_context=options.input2_post_context, data_dir=data_dir,
        test_file_pattern='trial02', final_batch_size=256,
        shuffle_buffer_size=0, device='cpu').create_dataset('test')
    for path in (got_dir, want_dir):
        port = serve.load_model(path, 'lda', 'cpu')
        ref = jax_infer_cli.load_model(path, 'lda')
        assert port.model_inputs == ref.model_inputs
        np.testing.assert_allclose(port.frame_scores(test)[0],
                                   ref.frame_scores(test)[0],
                                   rtol=1e-4, atol=1e-4)


CASES = {
    # The skill's linear recipe, through the port's command line, into
    # a summary directory named by the PARAMS token.
    'linear_params_token': dict(summary_dir='{tmp}/sweep/PARAMS'),
    'linear_reference_protocol': dict(protocol='reference'),
    'linear_auto_streamed': dict(),
    'cca': dict(dnn_regressor='cca'),
    'cca_streamed': dict(dnn_regressor='cca', streaming_fit=True),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_run_decoding_experiment_matches_jax(tmp_path, records_dir,
                                             monkeypatch, case):
    changes = {k: v.format(tmp=tmp_path) if isinstance(v, str) else v
               for k, v in CASES[case].items()}
    if case == 'linear_auto_streamed':
        # Any corpus is "large": both drivers pick the streamed fit.
        monkeypatch.setenv('TDT_STREAMING_AUTO_BYTES', '1')
    want_options = _options(jax_decoding, tmp_path, records_dir, **changes)
    _, want_test, want_dprime = jax_decoding.run_decoding_experiment(
        want_options)
    want_path, want_text = _read_results(tmp_path)
    model_dir = str(tmp_path / 'model')
    want_dir = str(tmp_path / 'model_jax')
    shutil.move(model_dir, want_dir)

    got_options = _options(decoding, tmp_path, records_dir, **changes)
    if case == 'linear_params_token':
        assert decoding.main(_argv(got_options)) == 0
    else:
        _, got_test, got_dprime = decoding.run_decoding_experiment(
            got_options, device='cpu')
        assert list(got_test) == list(want_test)
        assert got_dprime == pytest.approx(want_dprime, rel=DPRIME_REL)
    got_path, got_text = _read_results(tmp_path)
    assert got_path == want_path
    if case == 'linear_params_token':
        assert '/sweep/attended_field=,batch_norm=False,' in got_path
    _assert_results_match(got_text, want_text)
    assert re.search(r'Final_Testing/dprime: ', got_text)
    assert sorted(os.listdir(model_dir)) == sorted(os.listdir(want_dir)) \
        == ['decoder_model.json', 'model.json', 'weights.npz']
    _assert_decoder_json_match(model_dir, want_dir)
    _assert_dirs_load_across(model_dir, want_dir, records_dir, got_options)


def test_check_file_pattern_mode_matches_jax(tmp_path, records_dir, capsys):
    """With check_file_pattern set, both drivers count the records of
    every file and return empty results without fitting."""
    for module in (jax_decoding, decoding):
        options = _options(module, tmp_path, records_dir,
                           check_file_pattern='.')
        kwargs = {} if module is jax_decoding else {'device': 'cpu'}
        assert module.run_decoding_experiment(options, **kwargs) == \
            ({}, {}, 0.0)
        assert 'Found 3 files for TFExample data analysis.' in \
            capsys.readouterr().out
    assert not os.path.exists(str(tmp_path / 'model'))


def _jax_flags():
    from absl import flags
    by_module = flags.FLAGS.flags_by_module_dict()
    return {f.name: f for f in by_module[jax_decoding.__name__]}


def test_every_jax_flag_parses_with_its_default():
    parser = decoding.build_parser()
    defaults = parser.parse_args([])
    jax_flags = _jax_flags()
    assert 'dnn_regressor' in jax_flags and 'trace_dir' in jax_flags
    for name, flag in jax_flags.items():
        assert getattr(defaults, name) == flag.default, name
        if isinstance(flag.default, bool):
            forms = (['--' + name], ['--no' + name], ['--%s=false' % name])
            values = (True, False, False)
        else:
            value = flag.default if flag.default is not None else 'x'
            if getattr(flag.parser, 'enum_values', None):
                value = flag.parser.enum_values[-1]
            forms = (['--%s=%s' % (name, value)], ['--' + name, str(value)])
            values = (type(flag.default)(value)
                      if flag.default is not None else value,) * 2
        for argv, value in zip(forms, values):
            assert getattr(parser.parse_args(argv), name) == value, argv
    # DecodingOptions keeps exactly the JAX fields: device and trace_dir
    # stay out of the Parameters line and the PARAMS directory.
    assert decoding.DecodingOptions().experiment_parameters() == \
        jax_decoding.DecodingOptions().experiment_parameters()
    assert defaults.device == 'cuda'
    with pytest.raises(SystemExit):
        parser.parse_args(['--dnn_regressor=ridge'])


@pytest.mark.parametrize('kind', ['tf'])
def test_unported_model_kinds_raise(tmp_path, records_dir, kind):
    """tf is a flag-parity value with no model, in both packages (the
    SGD families: test_torch_sgd_models.py)."""
    options = _options(decoding, tmp_path, records_dir, dnn_regressor=kind)
    with pytest.raises(ValueError, match='no buildable'):
        decoding.create_brain_model(options, None, device='cpu')


def _event_dirs(root):
    """Subdirectories (below the run's timestamp) holding event files."""
    return sorted(os.path.relpath(d, root).split(os.sep, 1)[1]
                  for d, _, files in os.walk(root)
                  if any(f.startswith('events.out.tfevents') for f in files))


def test_tensorboard_and_trace_dirs(tmp_path, records_dir):
    """--tensorboard_dir gets the JAX driver's event files (parameters,
    test results, d'); --trace_dir gets a torch.profiler trace."""
    jax_decoding.run_decoding_experiment(_options(
        jax_decoding, tmp_path, records_dir,
        tensorboard_dir=str(tmp_path / 'tb_jax')))
    options = _options(decoding, tmp_path, records_dir,
                       tensorboard_dir=str(tmp_path / 'tb_port'))
    trace_dir = str(tmp_path / 'trace')
    assert decoding.main(_argv(options) + ['--trace_dir', trace_dir]) == 0
    assert _event_dirs(str(tmp_path / 'tb_port')) == \
        _event_dirs(str(tmp_path / 'tb_jax')) == ['dprime', 'results',
                                                  'train']
    assert os.path.getsize(os.path.join(trace_dir, 'trace.json')) > 0
