"""The regression (jackknife x lambda) driver of the PyTorch port vs the
JAX driver.

Both drivers run the same flags on the same TFRecords (5 files of
240-580 ragged frames, 6 EEG channels, a planted TRF with post context
4), one into each summary directory. The per-lambda results.txt files
must agree line for line: the directory names and the text exactly, the
mean and std within 1e-4 absolute. So must the CSV (lambda column
exactly, correlations within 1e-4) and the returned {lambda: (mean,
std)} (keys exactly). The sweep engine's own tolerances are in
tests/test_torch_sweep.py.
"""

import os
import re

import numpy as np
import pytest
import torch
from absl.testing import flagsaver

from telluride_decoding_tpu.cli import decoding as jax_decoding
from telluride_decoding_tpu.cli import regression as jax_regression
from telluride_decoding_tpu.data import records
from telluride_decoding_torch.cli import decoding, regression
from telluride_decoding_torch.ops.lagstack import lag_stack_np
from telluride_decoding_torch.sweep import engine

TOL = 1e-4
LAMBDAS = '1e-4,1e-2,1'
LENGTHS = (240, 410, 360, 580, 300)
_NUMBER = re.compile(r'(mean correlation|std)=([-+0-9.e]+|nan)')


@pytest.fixture
def records_dir(tmp_path):
    """Five ragged files: eeg (6 channels) and intensity, a lag-stacked
    TRF of the EEG (post context 4) plus noise."""
    rng = np.random.RandomState(0)
    w = rng.randn(6 * 5, 1).astype(np.float32)
    d = tmp_path / 'records'
    d.mkdir()
    for i, n in enumerate(LENGTHS):
        eeg = rng.randn(n, 6).astype(np.float32)
        intensity = (lag_stack_np(eeg, 0, 4) @ w +
                     0.5 * rng.randn(n, 1)).astype(np.float32)
        records.convert_data_to_tfrecords(
            {'eeg': eeg, 'intensity': intensity},
            str(d / ('trial%02d.tfrecords' % i)))
    return str(d)


def _flags(records_dir, out_dir, test_name, **extra):
    values = dict(tfexample_dir=records_dir, test_name=test_name,
                  post_context=4, regularization_list=LAMBDAS,
                  summary_base_dir=os.path.join(out_dir, 'summary'),
                  results_csv_file=os.path.join(out_dir, 'results.csv'))
    values.update(extra)
    return values


def _run_jax(values):
    jax_regression.FLAGS(['prog'])
    with flagsaver.flagsaver(**values):
        jax_regression.main(['prog'])


def _run_port(values):
    argv = ['--%s=%s' % (k, v) for k, v in sorted(values.items())]
    assert regression.main(argv + ['--device', 'cpu']) == 0


def _read_summaries(summary_dir):
    found = {}
    for name in sorted(os.listdir(summary_dir)):
        with open(os.path.join(summary_dir, name, 'results.txt')) as f:
            found[name] = f.read().splitlines()
    return found


def _assert_summary_lines_match(got, want):
    assert len(got) == len(want) == 2
    assert _NUMBER.sub('', got[0]) == _NUMBER.sub('', want[0])
    for (gk, gv), (wk, wv) in zip(_NUMBER.findall(got[0]),
                                  _NUMBER.findall(want[0])):
        assert gk == wk
        assert float(gv) == pytest.approx(float(wv), rel=0, abs=TOL)
    assert got[1] == want[1]


def _read_csv(path):
    with open(path) as f:
        return [line.strip().split(',') for line in f]


def _assert_outputs_match(got_dir, want_dir):
    got = _read_summaries(os.path.join(got_dir, 'summary'))
    want = _read_summaries(os.path.join(want_dir, 'summary'))
    assert sorted(got) == sorted(want)
    for name in want:
        _assert_summary_lines_match(got[name], want[name])
    got_csv = _read_csv(os.path.join(got_dir, 'results.csv'))
    want_csv = _read_csv(os.path.join(want_dir, 'results.csv'))
    assert [r[0] for r in got_csv] == [r[0] for r in want_csv]
    np.testing.assert_allclose(
        np.asarray([r[1:] for r in got_csv], float),
        np.asarray([r[1:] for r in want_csv], float), rtol=0, atol=TOL)


@pytest.mark.parametrize('test_name', ['jens_memory_linear',
                                       'jens_memory_cca'])
def test_main_matches_jax(records_dir, tmp_path, test_name):
    for side, run in (('jax', _run_jax), ('torch', _run_port)):
        run(_flags(records_dir, str(tmp_path / side), test_name))
    _assert_outputs_match(str(tmp_path / 'torch'), str(tmp_path / 'jax'))
    names = sorted(os.listdir(str(tmp_path / 'torch' / 'summary')))
    assert names == sorted(
        'reglambda_{}_test_None'.format(l)
        for l in np.asarray(np.float32([1e-4, 1e-2, 1]), np.float64))


def test_main_with_checkpoints_and_test_file_matches_jax(records_dir,
                                                         tmp_path):
    for side, run in (('jax', _run_jax), ('torch', _run_port)):
        run(_flags(records_dir, str(tmp_path / side), 'jens_memory_linear',
                   test_file='trial03', sweep_lambda_block=2,
                   sweep_checkpoint_dir=str(tmp_path / side / 'ckpt')))
    _assert_outputs_match(str(tmp_path / 'torch'), str(tmp_path / 'jax'))
    got = _read_csv(str(tmp_path / 'torch' / 'results.csv'))
    assert [len(row) for row in got] == [2, 2, 2]


def test_jax_checkpoint_resumes_in_the_port_driver(records_dir, tmp_path,
                                                   monkeypatch):
    """A checkpoint directory the JAX driver finished serves the port's
    whole grid: no sweep runs, and the outputs match the JAX run's."""
    ckpt = str(tmp_path / 'ckpt')
    _run_jax(_flags(records_dir, str(tmp_path / 'jax'), 'jens_memory_cca',
                    sweep_lambda_block=1, sweep_checkpoint_dir=ckpt))

    def no_sweep(*args, **kwargs):
        raise AssertionError('the checkpoint should have served the grid')
    monkeypatch.setattr(engine, 'cca_jackknife_sweep', no_sweep)
    _run_port(_flags(records_dir, str(tmp_path / 'torch'),
                     'jens_memory_cca', sweep_lambda_block=1,
                     sweep_checkpoint_dir=ckpt))
    _assert_outputs_match(str(tmp_path / 'torch'), str(tmp_path / 'jax'))


def _options(module, records_dir, **changes):
    values = dict(tfexample_dir=records_dir, post_context=4,
                  dnn_regressor='linear', input_field='eeg',
                  output_field='intensity',
                  test_metric='pearson_correlation_first')
    values.update(changes)
    return module.DecodingOptions().set_from_dict(values)


def _assert_results_match(got, want):
    assert list(got) == list(want)
    for lamb in want:
        np.testing.assert_allclose(got[lamb], want[lamb], rtol=0, atol=TOL)


@pytest.mark.parametrize('preset', ['RegressionLinear', 'RegressionCCA'])
def test_jackknife_over_regularizations_matches_jax(records_dir, tmp_path,
                                                    preset):
    results = {}
    for side, dec, reg, kwargs in (
            ('jax', jax_decoding, jax_regression, {}),
            ('torch', decoding, regression, {'device': 'cpu'})):
        my_flags = _options(dec, records_dir)
        obj = getattr(reg, preset)(my_flags, **kwargs)
        obj.preset_flags()
        results[side] = obj.jackknife_over_regularizations(
            my_flags, [1e-4, 1e-1], summary_base_dir=str(tmp_path / side))
    _assert_results_match(results['torch'], results['jax'])
    assert results['torch'][1e-4][0] > 0.9


def test_protocol_reference_matches_jax(records_dir, tmp_path):
    """--protocol reference runs each cell through jackknife_one_model
    (train_and_test on shuffled drop-remainder batches), in both."""
    results, whole = {}, {}
    for side, dec, reg, kwargs in (
            ('jax', jax_decoding, jax_regression, {}),
            ('torch', decoding, regression, {'device': 'cpu'})):
        for protocol, out in (('reference', results),
                              ('whole_split', whole)):
            my_flags = _options(dec, records_dir, batch_size=128,
                                shuffle_buffer_size=0, protocol=protocol)
            out[side] = reg.Regression(my_flags, **kwargs) \
                .jackknife_over_regularizations(
                    my_flags, [1e-2],
                    summary_base_dir=str(tmp_path / protocol / side))
    _assert_results_match(results['torch'], results['jax'])
    _assert_results_match(whole['torch'], whole['jax'])
    # The protocols differ on a ragged corpus: the flag reached the
    # per-cell route.
    assert abs(results['torch'][1e-2][0] - whole['torch'][1e-2][0]) > 1e-6


def test_jackknife_one_model_matches_jax(records_dir, tmp_path):
    scores = {}
    for side, dec, reg, kwargs in (
            ('jax', jax_decoding, jax_regression, {}),
            ('torch', decoding, regression, {'device': 'cpu'})):
        my_flags = _options(dec, records_dir, train_file_pattern='allbut',
                            regularization_lambda=1e-2)
        data = reg.get_brain_data_object(my_flags, **kwargs)
        files = data.all_files()
        my_flags.validate_file_pattern = my_flags.test_file_pattern = \
            files[0]
        model = reg.get_brain_model(data.create_dataset('test'), my_flags,
                                    **kwargs)
        summary = str(tmp_path / (side + '.txt'))
        scores[side] = reg.jackknife_one_model(
            data, model, None, my_flags, summary_file=summary)
        with open(summary) as f:
            scores[side + '_log'] = f.read().splitlines()
    np.testing.assert_allclose(scores['torch'], scores['jax'], rtol=0,
                               atol=TOL)
    assert len(scores['torch']) == len(LENGTHS)
    _assert_summary_lines_match(scores['torch_log'], scores['jax_log'])


@pytest.mark.parametrize('input_offset', [0, 2, -3])
def test_device_context_equals_host_stacking(records_dir, tmp_path,
                                             monkeypatch, input_offset):
    out = {}
    for env in ('1', '0'):
        monkeypatch.setenv('TDT_DEVICE_CONTEXT', env)
        my_flags = _options(decoding, records_dir, pre_context=2,
                            input_offset=input_offset)
        out[env] = regression.RegressionLinear(my_flags, device='cpu') \
            .jackknife_over_regularizations(
                my_flags, [1e-4, 1e-1],
                summary_base_dir=str(tmp_path / env))
    _assert_results_match(out['1'], out['0'])


def test_parse_regularization_values_matches_jax():
    for spec in ('normal', 'test', 'NORMAL', '0.1,1,10', '1e-6,3e-2'):
        got = regression.parse_regularization_values(spec)
        want = jax_regression.parse_regularization_values(spec)
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype
    assert regression.parse_regularization_values(0.5) == [0.5]
    with pytest.raises(ValueError, match='Could not parse'):
        regression.parse_regularization_values('abc,def')
    with pytest.raises(TypeError):
        regression.parse_regularization_values(3)


@pytest.mark.parametrize('test_name', regression.TEST_NAMES)
def test_presets_match_jax(test_name):
    got_flags, want_flags = (decoding.DecodingOptions(),
                             jax_decoding.DecodingOptions())
    got = regression.select_regression_object(test_name, got_flags)
    want = jax_regression.select_regression_object(test_name, want_flags)
    assert type(got).__name__ == type(want).__name__
    assert got.preset_flags() == want.preset_flags()
    assert got_flags.experiment_parameters() == \
        want_flags.experiment_parameters()
    assert got.device == 'cuda'


def test_illegal_test_name_raises():
    with pytest.raises(TypeError, match='Illegal test name'):
        regression.select_regression_object('nope',
                                            decoding.DecodingOptions())
    with pytest.raises(SystemExit):
        regression.build_parser().parse_args(['--test_name', 'nope'])


def test_main_defaults_to_the_card(records_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('checks the error on a machine without a card')
    values = _flags(records_dir, str(tmp_path), 'jens_memory_linear')
    with pytest.raises(RuntimeError, match='No CUDA device'):
        regression.main(['--%s=%s' % kv for kv in sorted(values.items())])


def test_flags_cover_the_jax_driver():
    """Every flag of the JAX regression and decoding drivers parses here
    with its default (plus --device)."""
    parser = regression.build_parser()
    ours = {a.dest for a in parser._actions}
    jax_regression.define_flags()
    for name in ('run_number', 'max_test_count', 'regularization_list',
                 'test_name', 'cache', 'test_file', 'model_base_dir',
                 'plot_base_dir', 'summary_base_dir', 'results_csv_file',
                 'sweep_checkpoint_dir', 'sweep_lambda_block'):
        assert name in ours, name
        assert parser.get_default(name) == \
            jax_regression.FLAGS[name].default, name
    assert parser.get_default('device') == 'cuda'
