"""The SGD families in the sweep drivers of the PyTorch port vs the JAX
package: cli.regression's per-cell route (jackknife_one_model) and
cli.cohort's general jackknife (general_cohort_results) with its lambda
dedup and its per-subject checkpoints.

The dense fit draws from torch generators, so a driver's numbers are
held to the JAX package's only where the batch stream is the same: the
streamed fit from carried parameters (1e-4, as in
test_torch_sgd_models.py). Elsewhere the port must run the same cells,
write the same files and lines, and learn the planted TRF (held-out r
above 0.9 in both packages). Checkpoints are JAX's file format: a JAX
checkpoint resumes in the port with no training and the same cohort
CSV, and the refusals give the JAX text.
"""

import dataclasses
import os
import re

import jax
import numpy as np
import pytest

from telluride_decoding_tpu.cli import cohort as jax_cohort
from telluride_decoding_tpu.cli import decoding as jax_decoding
from telluride_decoding_tpu.cli import regression as jax_regression
from telluride_decoding_torch.cli import cohort, decoding, regression
from telluride_decoding_torch.models import convert

from conftest import write_cohort_tree

TOL = 1e-4
QUALITY = 0.9
_NUMBER = re.compile(r'(mean correlation|std)=([-+0-9.e]+|nan)')
SGD = dict(input_field='eeg', output_field='intensity', pre_context=0,
           post_context=4, dnn_regressor='fullyconnected',
           hidden_units='8', learning_rate=1e-2, epoch_count=10,
           batch_size=128, train_file_pattern='allbut',
           shuffle_buffer_size=0)
LAMBDAS = [1e-5, 1e-2, 10.0]


def _options(module, **values):
    return module.DecodingOptions().set_from_dict(dict(SGD, **values))


@pytest.fixture
def records_dir(tmp_path, rng):
    """One subject of the JAX suite's cohort tree: 4 ragged trials with a
    planted lag-stacked TRF (post context 4)."""
    root = write_cohort_tree(tmp_path, rng, num_subjects=1, trials=4, n=500)
    return os.path.join(root, 'subject00')


# -- cli.regression -----------------------------------------------------------

@pytest.mark.parametrize('protocol', ['whole_split', 'reference'])
def test_regression_sgd_route_matches_jax(records_dir, tmp_path, protocol):
    """jackknife_over_regularizations of a DNN on both protocols: the
    same per-lambda results.txt lines (numbers aside) and both packages
    over the quality bar at every lambda."""
    found = {}
    for name, module, reg, extra in (
            ('jax', jax_decoding, jax_regression, {}),
            ('torch', decoding, regression, {'device': 'cpu'})):
        flags = _options(module, tfexample_dir=records_dir,
                         protocol=protocol)
        summary = str(tmp_path / name)
        results = reg.Regression(flags, **extra) \
            .jackknife_over_regularizations(flags, [1e-2, 1.0],
                                            summary_base_dir=summary)
        lines = {}
        for sub in sorted(os.listdir(summary)):
            with open(os.path.join(summary, sub, 'results.txt')) as f:
                lines[sub] = [_NUMBER.sub('', line).replace(
                    summary, '') for line in f]
        found[name] = (lines, results)
        for mean, _ in results.values():
            assert mean > QUALITY, (name, results)
    assert found['torch'][0] == found['jax'][0]
    assert list(found['torch'][1]) == list(found['jax'][1])


def test_regression_streamed_sgd_cells_match_jax(records_dir):
    """jackknife_one_model with --streaming_fit from carried parameters:
    the same held-out correlations, the one model refit from its last
    parameters fold after fold, as in the JAX package."""
    correlations = {}
    jax_model = None
    for name, module, reg, extra in (
            ('jax', jax_decoding, jax_regression, {}),
            ('torch', decoding, regression, {'device': 'cpu'})):
        flags = _options(module, tfexample_dir=records_dir,
                         streaming_fit=True, epoch_count=2)
        data = reg.get_brain_data_object(flags, **extra)
        files = sorted(data.all_files())
        flags.validate_file_pattern = flags.test_file_pattern = files[0]
        if name == 'jax':
            jax_model = reg.get_brain_model(data.create_dataset('test'),
                                            flags)
            jax_model.params = jax_model._init_params(
                jax.random.PRNGKey(0))
            model = jax_model
            start = jax.tree_util.tree_map(np.asarray, jax_model.params)
        else:
            model = convert.sgd_params_from_numpy(
                'BrainModelDNN', start, 'cpu', jax_model.config())
            model.compile(learning_rate=flags.learning_rate)
        correlations[name] = reg.jackknife_one_model(data, model, None,
                                                     flags)
    np.testing.assert_allclose(correlations['torch'], correlations['jax'],
                               rtol=0, atol=TOL)


# -- cli.cohort ---------------------------------------------------------------

@pytest.fixture
def cohort_dir(tmp_path, rng):
    return write_cohort_tree(tmp_path, rng, num_subjects=2, trials=3, n=400)


def _port_cohort(cohort_dir, tmp_path, name, kind='fullyconnected',
                 checkpoint_dir=None, **values):
    csv = str(tmp_path / (name + '.csv'))
    results, summary = cohort.run_cohort_sweep(
        _options(decoding, dnn_regressor=kind, **values),
        cohort.discover_subjects(cohort_dir, []), LAMBDAS,
        cohort_csv_file=csv, checkpoint_dir=checkpoint_dir, device='cpu')
    with open(csv) as f:
        return results, summary, f.read()


def test_cohort_trains_the_sgd_families(cohort_dir, tmp_path):
    """Per subject a lambda x trial grid of held-out correlations over
    the quality bar, and the JAX driver's cohort CSV lines."""
    results, (mean, _), text = _port_cohort(cohort_dir, tmp_path, 'port')
    assert sorted(results) == ['subject00', 'subject01']
    for res in results.values():
        assert res.correlations.shape == (len(LAMBDAS), 3)
        np.testing.assert_array_equal(res.lambdas, LAMBDAS)
    assert np.all(mean > QUALITY)
    lines = text.splitlines()
    assert lines[0] == 'lambda,mean,std' and len(lines) == 1 + len(LAMBDAS)


def test_lambda_dedup_equals_full_retraining(cohort_dir, tmp_path,
                                             monkeypatch):
    """fullyconnected ignores the lambda and trains seeded: one trained
    row tiled is bit for bit the grid of every row trained."""
    calls = []
    jackknife = regression.jackknife_one_model
    monkeypatch.setattr(regression, 'jackknife_one_model',
                        lambda *a, **k: calls.append(1) or jackknife(*a,
                                                                     **k))
    deduped = _port_cohort(cohort_dir, tmp_path, 'dedup')
    assert len(calls) == 2
    monkeypatch.setenv('TDT_GENERAL_LAMBDA_DEDUP', '0')
    full = _port_cohort(cohort_dir, tmp_path, 'full')
    assert len(calls) == 2 + 2 * len(LAMBDAS)
    assert deduped[2] == full[2]
    for name in deduped[0]:
        np.testing.assert_array_equal(deduped[0][name].correlations,
                                      full[0][name].correlations)


def test_dcca_and_mismatch_batches_are_not_deduped(cohort_dir, monkeypatch):
    """dcca reads the lambda (its final CCA) and mismatch batches draw a
    new stream for each row: every row trains, as in the JAX package."""
    rows = []
    monkeypatch.setattr(regression, 'jackknife_one_model',
                        lambda bd, model, *a, **k: rows.append(
                            model._reg if hasattr(model, '_reg') else 0)
                        or [0.5] * len(bd.all_files()))
    subjects = cohort.discover_subjects(cohort_dir, [])
    cohort.general_cohort_results(
        _options(decoding, dnn_regressor='dcca', input2_field='intensity',
                 cca_dimensions=1), subjects, LAMBDAS, device='cpu')
    assert rows == LAMBDAS * 2
    rows.clear()
    cohort.general_cohort_results(
        _options(decoding, dnn_regressor='classifier', mismatch_batch=True,
                 input2_field='intensity'), subjects, LAMBDAS, device='cpu')
    assert len(rows) == 2 * len(LAMBDAS)


def _no_training(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('a checkpointed subject was retrained')
    monkeypatch.setattr(regression, 'jackknife_one_model', refuse)


def test_resume_from_port_checkpoints(cohort_dir, tmp_path, monkeypatch,
                                      caplog):
    ckpt = str(tmp_path / 'ckpt')
    first = _port_cohort(cohort_dir, tmp_path, 'first', checkpoint_dir=ckpt)
    assert sorted(os.listdir(ckpt)) == ['general_subject00.npz',
                                        'general_subject01.npz']
    _no_training(monkeypatch)
    with caplog.at_level('INFO'):
        again = _port_cohort(cohort_dir, tmp_path, 'again',
                             checkpoint_dir=ckpt)
    assert again[2] == first[2]
    assert caplog.text.count('restored from') == 2


def test_resume_from_jax_checkpoints(cohort_dir, tmp_path, monkeypatch):
    """A JAX-written checkpoint directory resumes in the port with no
    training and gives the JAX run's cohort CSV."""
    ckpt = str(tmp_path / 'ckpt')
    jax_csv = str(tmp_path / 'jax.csv')
    subjects = jax_cohort.discover_subjects(cohort_dir, [])
    jax_cohort.run_cohort_sweep(_options(jax_decoding), subjects, LAMBDAS,
                                cohort_csv_file=jax_csv,
                                checkpoint_dir=ckpt)
    _no_training(monkeypatch)
    results, _, text = _port_cohort(cohort_dir, tmp_path, 'port',
                                    checkpoint_dir=ckpt)
    with open(jax_csv) as f:
        assert text == f.read()
    assert results['subject00'].test_files == sorted(
        cohort.regression.get_brain_data_object(
            dataclasses.replace(_options(decoding),
                                tfexample_dir=subjects['subject00']),
            'cpu').all_files())


def test_port_checkpoints_resume_in_jax(cohort_dir, tmp_path):
    ckpt = str(tmp_path / 'ckpt')
    _, _, text = _port_cohort(cohort_dir, tmp_path, 'port',
                              checkpoint_dir=ckpt)
    jax_csv = str(tmp_path / 'jax.csv')
    jax_cohort.run_cohort_sweep(
        _options(jax_decoding), jax_cohort.discover_subjects(cohort_dir, []),
        LAMBDAS, cohort_csv_file=jax_csv, checkpoint_dir=ckpt)
    with open(jax_csv) as f:
        assert f.read() == text


@pytest.mark.parametrize('change', ['lambdas', 'params', 'files', 'format'])
def test_checkpoint_mismatch_raises_the_jax_text(cohort_dir, tmp_path,
                                                  change):
    ckpt = str(tmp_path / 'ckpt')
    _port_cohort(cohort_dir, tmp_path, 'port', checkpoint_dir=ckpt)
    lambdas, values = LAMBDAS, {}
    if change == 'lambdas':
        lambdas = LAMBDAS[:2]
    elif change == 'params':
        values = dict(hidden_units='4')
    elif change == 'files':
        os.remove(os.path.join(cohort_dir, 'subject00',
                               'trial02.tfrecords'))
    else:
        path = os.path.join(ckpt, 'general_subject00.npz')
        with np.load(path) as z:
            stored = {k: z[k] for k in z.files}
        np.savez(path, **dict(stored, params=np.asarray(';'.join(
            stored['params']))))
    errors = []
    for module, driver, extra in ((decoding, cohort, {'device': 'cpu'}),
                                  (jax_decoding, jax_cohort, {})):
        with pytest.raises(ValueError) as error:
            driver.run_cohort_sweep(
                _options(module, **values),
                driver.discover_subjects(cohort_dir, []), lambdas,
                checkpoint_dir=ckpt, **extra)
        errors.append(str(error.value))
    assert errors[0] == errors[1]
    assert 'checkpoint' in errors[0]


def test_main_runs_an_explicit_sgd_family(cohort_dir, tmp_path, capsys):
    """--dnn_regressor fullyconnected routes to the general jackknife;
    an untouched flag still means linear."""
    argv = ['--cohort_dir', cohort_dir, '--input_field', 'eeg',
            '--output_field', 'intensity', '--post_context', '4',
            '--regularization_list', '1e-2,1', '--hidden_units', '8',
            '--epoch_count', '2', '--device', 'cpu']
    assert cohort.main(argv + ['--dnn_regressor', 'fullyconnected']) == 0
    out = capsys.readouterr().out
    assert 'Cohort sweep over 2 subjects, 2 lambdas:' in out
    rows = [line for line in out.splitlines() if 'lambda ' in line]
    # Deduped: the two lambda rows are the same numbers.
    assert rows[0].split('r =')[1].replace('  <-- best', '') == \
        rows[1].split('r =')[1].replace('  <-- best', '')


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_jackknife_refits_one_model_across_folds(records_dir, package):
    """Reference fault the port copies (ROADMAP.md section 3): the
    per-cell jackknife refits one model object, so each held-out fold
    starts from the parameters the fold before trained, on a split that
    held this fold's test trial."""
    module, reg, extra = ((jax_decoding, jax_regression, {})
                          if package == 'jax' else
                          (decoding, regression, {'device': 'cpu'}))
    flags = _options(module, tfexample_dir=records_dir, epoch_count=1)
    data = reg.get_brain_data_object(flags, **extra)
    files = sorted(data.all_files())
    flags.validate_file_pattern = flags.test_file_pattern = files[0]
    model = reg.get_brain_model(data.create_dataset('test'), flags, **extra)
    starts, ends = [], []
    fit = model.fit

    def weights():
        if model.params is None:
            return None
        if package == 'jax':
            return convert.flat_params(jax.tree_util.tree_map(
                np.asarray, model.params))
        return {k: v.numpy() for k, v in model.params.items()}

    def spy(dataset, **kwargs):
        starts.append(weights())
        result = fit(dataset, **kwargs)
        ends.append(weights())
        return result
    model.fit = spy
    reg.jackknife_one_model(data, model, None, flags)
    assert len(starts) == len(files) == 4 and starts[0] is None
    for start, end in zip(starts[1:], ends):
        for key in end:
            np.testing.assert_array_equal(start[key], end[key])
