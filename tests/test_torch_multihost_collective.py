"""The collective half of the port's multi-process cohort join and the
drivers under a process group (tests/test_multihost.py:209-332, case for
case, and the cohort and regression drivers under TDT_COORDINATOR).

Groups of gloo processes on the CPU (test_torch_parallel.run_group:
children import only torch, numpy and the port, and join through
``multihost.initialize``) against the JAX package on the same inputs.

Tolerances, each with its reason:
  * ``allgather_summary``, 2e-9 (tests/test_multihost.py:265-268): the
    join is float64, gathered as it is;
  * a cohort CSV from a group against the single process's and the JAX
    driver's, 1e-6 (tests/test_multihost.py:150-151, the JAX suite's bound
    for its partitioned driver): each partition pads its subjects to its
    own largest trial, so a ragged cohort's float32 grids differ in their
    last bits from the whole cohort's;
  * the regression driver's grid from a group, 2e-4 against one process
    (tests/test_parallel.py:161): file moments summed over the ranks; the
    group's ranks read only their own blocks of the files.
"""

import os

import numpy as np
import pytest

from telluride_decoding_tpu.cli import cohort as jax_cohort
from telluride_decoding_tpu.cli import decoding as jax_decoding
from telluride_decoding_torch.cli import cohort, regression
from telluride_decoding_torch.parallel import multihost
from telluride_decoding_torch.sweep.engine import SweepResult, \
    cohort_summary

from conftest import write_cohort_tree
from test_torch_parallel import run_group

SUMMARY_TOL = 2e-9
CSV_TOL = 1e-6
SWEEP_TOL = 2e-4
LAMBDAS = '1e-5,1e-2,1'


def _fake_results(rng, subjects=('s00', 's01', 's02'), num_l=4, files=3):
    return {
        name: SweepResult(rng.randn(num_l, files + i).astype(np.float64),
                          np.logspace(-4, 0, num_l),
                          ['f%d' % f for f in range(files + i)])
        for i, name in enumerate(subjects)}


class TestDistributedCollectiveJoin:

    def test_two_process_allgather_summary(self, tmp_path, rng):
        """A real 2-process gloo group: allgather_summary reduces the
        per-process partials with one collective and every process gets
        the exact cohort summary; initialize is idempotent."""
        results = _fake_results(rng)
        want_mean, want_std = cohort_summary(results)
        lambdas = results['s00'].lambdas
        inputs = {'lambdas': lambdas}
        for idx in range(2):
            for name, r in multihost.partition_subjects(results, idx,
                                                        2).items():
                inputs['%d/%s' % (idx, name)] = r.correlations
        body = '''
assert multihost.initialize() is True   # Idempotent.
from telluride_decoding_torch.sweep.engine import SweepResult
mine = {key.split('/')[1]: SweepResult(value, inputs['lambdas'],
                                       ['f'] * value.shape[1])
        for key, value in inputs.items() if key.startswith('%d/' % RANK)}
out['mean'], out['std'] = multihost.allgather_summary(inputs['lambdas'],
                                                      mine)
'''
        for out in run_group(str(tmp_path), body, inputs, world=2):
            np.testing.assert_allclose(out['mean'], want_mean, rtol=0,
                                       atol=SUMMARY_TOL)
            np.testing.assert_allclose(out['std'], want_std, rtol=0,
                                       atol=SUMMARY_TOL)

    def test_allgather_rejects_mismatched_lambda_grids(self, rng,
                                                       monkeypatch):
        """The collective join fails as loudly as the filesystem join
        when partitions swept different grids: the lambda row rides the
        collective and is cross-checked."""
        results = _fake_results(rng, subjects=('s00',))
        lambdas = results['s00'].lambdas

        def fake_allgather(array, mesh=None):
            mine = np.asarray(array)
            if mine.dtype == np.int64:   # The grid-length pre-check.
                return np.stack([mine, mine])
            other = mine.copy()
            other[3, 0] *= 10.0          # Different grid on process 1.
            return np.stack([mine, other])

        monkeypatch.setattr(multihost.mesh, 'gather', fake_allgather)
        with pytest.raises(ValueError, match='process 1 swept'):
            multihost.allgather_summary(lambdas, results)

    def test_allgather_rejects_mismatched_grid_lengths(self, rng,
                                                       monkeypatch):
        """Grids of different length would reach the main gather with
        mismatched shapes; the length pre-check catches them first."""
        results = _fake_results(rng, subjects=('s00',))
        lambdas = results['s00'].lambdas

        def fake_allgather(array, mesh=None):
            mine = np.asarray(array)
            if mine.dtype == np.int64:
                return np.stack([mine, mine + 1])   # Process 1: +1 lambda.
            raise AssertionError(
                'main gather ran despite mismatched grid lengths')

        monkeypatch.setattr(multihost.mesh, 'gather', fake_allgather)
        with pytest.raises(ValueError, match='different lengths'):
            multihost.allgather_summary(lambdas, results)

    def test_initialize_noop_without_env(self, monkeypatch):
        monkeypatch.delenv('TDT_COORDINATOR', raising=False)
        assert multihost.initialize() is False
        assert multihost.process_count() == 1
        assert multihost.process_index() == 0

    def test_initialize_incomplete_env_raises(self, monkeypatch):
        """The JAX package's text, in both packages."""
        from telluride_decoding_tpu.parallel import multihost as jax_mh
        monkeypatch.setenv('TDT_COORDINATOR', 'localhost:1')
        monkeypatch.delenv('TDT_NUM_PROCESSES', raising=False)
        monkeypatch.delenv('TDT_PROCESS_ID', raising=False)
        with pytest.raises(ValueError, match='TDT_NUM_PROCESSES') as got:
            multihost.initialize(device='cpu')
        with pytest.raises(ValueError) as want:
            jax_mh.initialize()
        assert str(got.value) == str(want.value)


def test_single_process_allgather_is_the_cohort_summary(rng):
    results = _fake_results(rng)
    got = multihost.allgather_summary(results['s00'].lambdas, results)
    for a, b in zip(got, cohort_summary(results)):
        np.testing.assert_allclose(a, b, rtol=1e-12)


DRIVERS_BODY = '''
import contextlib, io
from telluride_decoding_torch.cli import cohort, regression
base = str(inputs['base'])
text = io.StringIO()
with contextlib.redirect_stdout(text):
    assert cohort.main(list(inputs['cohort_argv']) + [
        '--cohort_csv_file', '%s/cohort_%d.csv' % (base, RANK)]) == 0
out['cohort_stdout'] = np.asarray(text.getvalue())
try:
    cohort.run_partitioned_cohort(None, {}, [1.0], partition_index=RANK,
                                  num_partitions=2, partition_dir=base)
    out['mismatch'] = np.asarray('')
except ValueError as error:
    out['mismatch'] = np.asarray(str(error))
assert regression.main(list(inputs['regression_argv']) + [
    '--summary_base_dir', '%s/regression_%d' % (base, RANK),
    '--results_csv_file', '%s/regression_%d.csv' % (base, RANK)]) == 0
from telluride_decoding_torch.cli import decoding
opts = decoding.DecodingOptions().set_from_dict(dict(
    input_field='eeg', output_field='intensity', post_context=4,
    dnn_regressor='linear', train_file_pattern='allbut'))
real_load = cohort._load_subject
for streaming in (True, False):
    loaded = []
    cohort._load_subject = (lambda name, *args, **kwargs:
                            loaded.append(name) or
                            real_load(name, *args, **kwargs))
    results, _ = cohort.run_cohort_sweep(
        opts, cohort.discover_subjects(str(inputs['root']), []),
        [1e-5, 1e-2], mesh=engine.default_mesh('subject', device='cpu'),
        device='cpu', streaming=streaming)
    cohort._load_subject = real_load
    out['api_loaded/%s' % streaming] = np.asarray(loaded)
    for name, result in results.items():
        out['api/%s/%s' % (streaming, name)] = result.correlations
'''


def test_drivers_under_a_process_group(tmp_path, rng):
    """cli.cohort and cli.regression in a group of 3 ranks (TDT_*
    variables): the cohort's partitions are the ranks, each reads only its
    own subjects, the join is one gather and rank 0 writes the CSV, which
    is the single process's and within 1e-6 of the JAX driver's; the
    regression sweep's files shard over the ranks and rank 0 writes its
    results; run_cohort_sweep with the group's mesh reads on each rank
    only its own subjects and gives every rank every subject. A
    partition count other than the group's is refused with the JAX
    package's text."""
    root = write_cohort_tree(tmp_path, rng, num_subjects=5)
    cohort_argv = ['--device', 'cpu', '--cohort_dir', root, '--input_field',
                   'eeg', '--output_field', 'intensity', '--post_context',
                   '4', '--regularization_list', LAMBDAS]
    regression_argv = ['--device', 'cpu', '--tfexample_dir',
                       os.path.join(root, 'subject01'), '--test_name',
                       'jens_memory_linear', '--post_context', '4',
                       '--regularization_list', LAMBDAS]
    outputs = run_group(str(tmp_path / 'group'), DRIVERS_BODY, dict(
        base=np.asarray(str(tmp_path)), cohort_argv=np.asarray(cohort_argv),
        regression_argv=np.asarray(regression_argv),
        root=np.asarray(root)), world=3)
    assert 'Cohort sweep over 3 partitions, 3 lambdas:' in str(
        outputs[0]['cohort_stdout'])
    assert 'Partition 2/3 done: 1 subjects swept.' in str(
        outputs[2]['cohort_stdout'])
    for rank in (1, 2):
        assert not os.path.exists(tmp_path / ('cohort_%d.csv' % rank))
        assert not os.path.exists(tmp_path / ('regression_%d.csv' % rank))
        assert not os.path.exists(tmp_path / ('regression_%d' % rank))
    for out in outputs:
        assert str(out['mismatch']) == (
            'num_partitions=2 but the torch.distributed group has 3 '
            'processes; they must match.')

    assert cohort.main(cohort_argv + [
        '--cohort_csv_file', str(tmp_path / 'single.csv')]) == 0
    joined = np.genfromtxt(tmp_path / 'cohort_0.csv', delimiter=',',
                           skip_header=1)
    alone = np.genfromtxt(tmp_path / 'single.csv', delimiter=',',
                          skip_header=1)
    np.testing.assert_allclose(joined, alone, rtol=0, atol=CSV_TOL)
    jax_flags = jax_decoding.DecodingOptions().set_from_dict(dict(
        input_field='eeg', output_field='intensity', pre_context=0,
        post_context=4, dnn_regressor='linear',
        train_file_pattern='allbut', shuffle_buffer_size=0))
    _, (mean, std) = jax_cohort.run_cohort_sweep(
        jax_flags, cohort.discover_subjects(root, []),
        [float(l) for l in LAMBDAS.split(',')], subject_parallel=False)
    np.testing.assert_allclose(joined[:, 1], mean, rtol=0, atol=CSV_TOL)
    np.testing.assert_allclose(joined[:, 2], std, rtol=0, atol=CSV_TOL)

    assert regression.main(regression_argv + [
        '--summary_base_dir', str(tmp_path / 'regression_single'),
        '--results_csv_file', str(tmp_path / 'regression_single.csv')]) == 0
    group_grid = np.genfromtxt(tmp_path / 'regression_0.csv', delimiter=',')
    single_grid = np.genfromtxt(tmp_path / 'regression_single.csv',
                                delimiter=',')
    np.testing.assert_allclose(group_grid, single_grid, rtol=0,
                               atol=SWEEP_TOL)
    assert os.path.isfile(tmp_path / 'regression_0' /
                          'reglambda_1.0_test_None' / 'results.txt')

    # run_cohort_sweep with the group's mesh, streamed and eager: each
    # rank reads only its share of the subjects (subject j is rank j mod
    # 3's), and every rank gets every subject's grid, the single
    # process's.
    from telluride_decoding_torch.cli import decoding
    opts = decoding.DecodingOptions().set_from_dict(dict(
        input_field='eeg', output_field='intensity', post_context=4,
        dnn_regressor='linear', train_file_pattern='allbut'))
    want, _ = cohort.run_cohort_sweep(
        opts, cohort.discover_subjects(root, []), [1e-5, 1e-2], device='cpu')
    names = list(want)
    for rank, out in enumerate(outputs):
        for streaming in (True, False):
            assert list(out['api_loaded/%s' % streaming]) == \
                names[rank::3]
            for name, result in want.items():
                np.testing.assert_allclose(
                    out['api/%s/%s' % (streaming, name)],
                    result.correlations, rtol=0, atol=SWEEP_TOL,
                    err_msg=name)


REGRESSION_BLOCK_BODY = '''
import os
from telluride_decoding_torch.cli import regression
from telluride_decoding_torch.data import records
opened = []
real_read = records.read_tfrecords
records.read_tfrecords = (lambda path, *args, **kwargs:
                          opened.append(os.path.basename(path)) or
                          real_read(path, *args, **kwargs))
base = str(inputs['base'])
assert regression.main(list(inputs['argv']) + [
    '--summary_base_dir', '%s/summary_%d' % (base, RANK),
    '--results_csv_file', '%s/grid_%d.csv' % (base, RANK)]) == 0
out['opened'] = np.asarray(opened, dtype=str)
'''


@pytest.mark.parametrize('test_name,device_context', [
    ('jens_memory_linear', '1'), ('jens_memory_linear', '0'),
    ('jens_memory_cca', '1')])
def test_regression_group_reads_only_its_block(tmp_path, rng, monkeypatch,
                                               test_name, device_context):
    """cli.regression in a group of 3 ranks on 4 files, which pad to 6:
    rank r reads (read_tfrecords, the whole-file reader) only the files of
    its block, [0, 2), [2, 4) and none for rank 2, whose block is padding
    only and still joins the collectives; rank 0's CSV is the single
    process's within 2e-4 (SWEEP_TOL). Raw streams with the lags stacked
    in the engine (TDT_DEVICE_CONTEXT=1) and host-stacked files (0), and
    the CCA grid."""
    from test_torch_parallel import subprocess_env
    root = write_cohort_tree(tmp_path, rng, num_subjects=1, trials=4)
    data_dir = os.path.join(root, 'subject00')
    argv = ['--device', 'cpu', '--tfexample_dir', data_dir, '--test_name',
            test_name, '--post_context', '4', '--regularization_list',
            LAMBDAS]
    env = dict(subprocess_env(), TDT_DEVICE_CONTEXT=device_context)
    outputs = run_group(str(tmp_path / 'group'), REGRESSION_BLOCK_BODY,
                        dict(base=np.asarray(str(tmp_path)),
                             argv=np.asarray(argv)), world=3, env=env)
    files = sorted(os.listdir(data_dir))
    assert len(files) == 4
    for rank, block in enumerate((files[0:2], files[2:4], [])):
        assert sorted(outputs[rank]['opened'].tolist()) == block, rank
    for rank in (1, 2):
        assert not os.path.exists(tmp_path / ('grid_%d.csv' % rank))

    monkeypatch.setenv('TDT_DEVICE_CONTEXT', device_context)
    assert regression.main(argv + [
        '--summary_base_dir', str(tmp_path / 'summary_single'),
        '--results_csv_file', str(tmp_path / 'single.csv')]) == 0
    group_grid = np.genfromtxt(tmp_path / 'grid_0.csv', delimiter=',')
    single_grid = np.genfromtxt(tmp_path / 'single.csv', delimiter=',')
    assert group_grid.shape == single_grid.shape == (3, 5)
    np.testing.assert_allclose(group_grid, single_grid, rtol=0,
                               atol=SWEEP_TOL)
