"""Multi-process cohort sweeps of the PyTorch port: partitioning, the exact
part-file join, and parts shared with the JAX package.

The part-file tests are the JAX suite's (tests/test_multihost.py,
TestPartition and TestPartJoin) run on the port's module; a part written
by either package must join in the other (same file name and JSON keys).
The joins reduce float64 (n, sum, sumsq), so a join equals
``cohort_summary`` to rtol 1e-12, the JAX suite's bound; the cohort CSV
of a partitioned run (written with %g) is held to 1e-6 of the single
run's, the JAX suite's bound for its own partitioned driver.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from telluride_decoding_tpu.parallel import multihost as jax_multihost
from telluride_decoding_tpu.sweep import engine as jax_engine
from telluride_decoding_torch.cli import cohort, decoding
from telluride_decoding_torch.parallel import multihost
from telluride_decoding_torch.sweep.engine import SweepResult, \
    cohort_summary

from conftest import write_cohort_tree

LINEAR = dict(input_field='eeg', output_field='intensity', pre_context=0,
              post_context=4, dnn_regressor='linear',
              train_file_pattern='allbut', shuffle_buffer_size=0)


def _fake_results(rng, subjects=('s00', 's01', 's02'), num_l=4, files=3,
                  result=SweepResult):
    return {
        name: result(rng.randn(num_l, files + i).astype(np.float64),
                     np.logspace(-4, 0, num_l),
                     ['f%d' % f for f in range(files + i)])
        for i, name in enumerate(subjects)
    }


class TestPartition:

    def test_round_robin_disjoint_and_complete(self):
        subjects = {'s%02d' % i: i for i in range(7)}
        shards = [multihost.partition_subjects(subjects, i, 3)
                  for i in range(3)]
        assert sorted(n for s in shards for n in s) == sorted(subjects)
        assert all(len(set(a) & set(b)) == 0
                   for i, a in enumerate(shards) for b in shards[i + 1:])
        # Deterministic: the same assignment when recomputed elsewhere,
        # and the JAX package's.
        assert shards[1] == multihost.partition_subjects(subjects, 1, 3)
        assert shards == [jax_multihost.partition_subjects(subjects, i, 3)
                          for i in range(3)]

    def test_list_input_and_empty_shard(self):
        names = ['b', 'a']
        assert multihost.partition_subjects(names, 0, 2) == ['a']
        assert multihost.partition_subjects(names, 1, 4) == ['b']
        assert multihost.partition_subjects(names, 3, 4) == []
        with pytest.raises(ValueError):
            multihost.partition_subjects(names, 2, 2)
        with pytest.raises(ValueError):
            multihost.partition_subjects(names, 0, 0)


class TestPartJoin:

    def test_join_equals_single_process_summary(self, tmp_path, rng):
        results = _fake_results(rng)
        lambdas = results['s00'].lambdas
        want_mean, want_std = cohort_summary(results)
        for idx in range(2):
            shard = multihost.partition_subjects(results, idx, 2)
            multihost.write_part(str(tmp_path), idx, lambdas, shard)
        mean, std, joined = multihost.join_parts(str(tmp_path), 2,
                                                 lambdas=lambdas)
        np.testing.assert_allclose(mean, want_mean, rtol=1e-12)
        np.testing.assert_allclose(std, want_std, rtol=1e-12)
        assert joined == ['s00', 's01', 's02']

    def test_empty_part_contributes_zero(self, tmp_path, rng):
        results = _fake_results(rng, subjects=('only',))
        lambdas = results['only'].lambdas
        multihost.write_part(str(tmp_path), 0, lambdas, results)
        multihost.write_part(str(tmp_path), 1, lambdas, {})
        mean, std, joined = multihost.join_parts(str(tmp_path), 2)
        want_mean, want_std = cohort_summary(results)
        np.testing.assert_allclose(mean, want_mean, rtol=1e-12)
        np.testing.assert_allclose(std, want_std, rtol=1e-12)
        assert joined == ['only']

    def test_missing_part_times_out_with_names(self, tmp_path, rng):
        results = _fake_results(rng, subjects=('s00',))
        multihost.write_part(str(tmp_path), 0, results['s00'].lambdas,
                             results)
        with pytest.raises(TimeoutError, match='cohort_part_00001'):
            multihost.join_parts(str(tmp_path), 2, timeout_s=0.2,
                                 poll_s=0.05)

    def test_lambda_grid_mismatch_raises(self, tmp_path, rng):
        results = _fake_results(rng, subjects=('s00',))
        multihost.write_part(str(tmp_path), 0, [1.0, 2.0, 3.0, 4.0],
                             results)
        multihost.write_part(str(tmp_path), 1, [1.0, 2.0, 3.0, 9.0], {})
        with pytest.raises(ValueError, match='swept lambdas'):
            multihost.join_parts(str(tmp_path), 2)

    def test_results_and_lambdas_disagree(self, tmp_path, rng):
        results = _fake_results(rng, subjects=('s00',))
        with pytest.raises(ValueError, match='4 lambda rows but 3'):
            multihost.write_part(str(tmp_path), 0, [1.0, 2.0, 3.0],
                                 results)
        with pytest.raises(ValueError, match='at least one subject'):
            multihost.summary_stats({})

    def test_stale_part_from_other_cohort_rejected(self, tmp_path, rng):
        """A leftover part covering another subject shard (a reused
        partition_dir) fails loudly instead of joining."""
        results = _fake_results(rng, subjects=('sA', 'sB'))
        lambdas = results['sA'].lambdas
        multihost.write_part(str(tmp_path), 0, lambdas,
                             {'sA': results['sA']})
        multihost.write_part(str(tmp_path), 1, lambdas,
                             {'sZ': results['sB']})
        with pytest.raises(ValueError, match='stale part'):
            multihost.join_parts(
                str(tmp_path), 2,
                expected_shards={0: ['sA'], 1: ['sB']})
        multihost.write_part(str(tmp_path), 1, lambdas,
                             {'sB': results['sB']})
        _, _, joined = multihost.join_parts(
            str(tmp_path), 2, expected_shards={0: ['sA'], 1: ['sB']})
        assert joined == ['sA', 'sB']

    def test_clean_parts(self, tmp_path, rng):
        results = _fake_results(rng, subjects=('s00',))
        multihost.write_part(str(tmp_path), 0, results['s00'].lambdas,
                             results)
        assert os.path.exists(multihost.part_path(str(tmp_path), 0))
        multihost.clean_parts(str(tmp_path))
        assert not os.path.exists(multihost.part_path(str(tmp_path), 0))

    def test_part_file_is_json_with_subjects(self, tmp_path, rng):
        results = _fake_results(rng, subjects=('sA', 'sB'))
        path = multihost.write_part(str(tmp_path), 3,
                                    results['sA'].lambdas, results)
        payload = json.load(open(path))
        assert payload['partition_index'] == 3
        assert payload['subjects'] == ['sA', 'sB']
        assert len(payload['n']) == 4

    def test_reduce_stats_matches_jax(self, rng):
        results = _fake_results(rng)
        stats = multihost.summary_stats(results)
        np.testing.assert_array_equal(
            stats, jax_multihost.summary_stats(results))
        for got, want in zip(multihost.reduce_stats(stats),
                             jax_multihost.reduce_stats(stats)):
            np.testing.assert_array_equal(got, want)


class TestPartsAcrossPackages:

    def test_same_part_file_as_jax(self, tmp_path, rng):
        results = _fake_results(rng)
        lambdas = results['s00'].lambdas
        ours = multihost.write_part(str(tmp_path / 'torch'), 2, lambdas,
                                    results)
        theirs = jax_multihost.write_part(str(tmp_path / 'jax'), 2,
                                          lambdas, results)
        assert os.path.basename(ours) == os.path.basename(theirs)
        with open(ours) as a, open(theirs) as b:
            assert json.load(a) == json.load(b)

    @pytest.mark.parametrize('writers', [('jax', 'jax'), ('torch', 'torch'),
                                         ('jax', 'torch'),
                                         ('torch', 'jax')])
    def test_parts_join_in_either_package(self, tmp_path, rng, writers):
        """Part 0 and part 1 written by the named packages; both
        packages' joins give the single-process summary."""
        results = _fake_results(rng, result=jax_engine.SweepResult)
        lambdas = results['s00'].lambdas
        want_mean, want_std = jax_engine.cohort_summary(results)
        for idx, writer in enumerate(writers):
            module = jax_multihost if writer == 'jax' else multihost
            module.write_part(str(tmp_path), idx, lambdas,
                              multihost.partition_subjects(results, idx, 2))
        expected = {0: ['s00', 's02'], 1: ['s01']}
        for module in (multihost, jax_multihost):
            mean, std, joined = module.join_parts(
                str(tmp_path), 2, lambdas=lambdas,
                expected_shards=expected)
            np.testing.assert_allclose(mean, want_mean, rtol=1e-12)
            np.testing.assert_allclose(std, want_std, rtol=1e-12)
            assert joined == ['s00', 's01', 's02']


class TestPartitionedDriver:

    def test_two_process_cli_matches_single(self, tmp_path, rng,
                                            cpu_subprocess_env):
        """Two port processes (shell fan-out, file join) give the single
        process's cohort CSV; the worker writes no summary."""
        root = write_cohort_tree(tmp_path, rng, num_subjects=3)
        base = [sys.executable, '-m', 'telluride_decoding_torch.cli.cohort',
                '--device', 'cpu', '--cohort_dir', root,
                '--input_field', 'eeg', '--output_field', 'intensity',
                '--post_context', '4', '--regularization_list', '1e-5,1e-2',
                '--partition_dir', str(tmp_path / 'parts')]
        procs = [subprocess.Popen(
            base + ['--num_partitions', '2', '--partition_index', str(idx),
                    '--cohort_csv_file', str(tmp_path / ('c%d.csv' % idx))],
            env=cpu_subprocess_env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for idx in range(2)]
        outs = [p.communicate(timeout=600) for p in procs]
        for p, (_, err) in zip(procs, outs):
            assert p.returncode == 0, err[-3000:]
        assert 'Cohort sweep over 2 partitions, 2 lambdas:' in outs[0][0]
        assert 'Partition 1/2 done: 1 subjects swept.' in outs[1][0]
        single = subprocess.run(
            base + ['--cohort_csv_file', str(tmp_path / 'single.csv')],
            env=cpu_subprocess_env, capture_output=True, text=True,
            timeout=600)
        assert single.returncode == 0, single.stderr[-3000:]
        joined = np.genfromtxt(tmp_path / 'c0.csv', delimiter=',',
                               skip_header=1)
        alone = np.genfromtxt(tmp_path / 'single.csv', delimiter=',',
                              skip_header=1)
        np.testing.assert_allclose(joined, alone, atol=1e-6)
        assert not os.path.exists(tmp_path / 'c1.csv')
        # The port's parts join in the JAX package too (the drivers
        # parse the lambda list as float32).
        mean, _, subjects = jax_multihost.join_parts(
            str(tmp_path / 'parts'), 2,
            lambdas=np.float32([1e-5, 1e-2]))
        np.testing.assert_allclose(mean, alone[:, 1], atol=1e-6)
        assert subjects == ['subject00', 'subject01', 'subject02']

    def test_api_partitioned_summary(self, tmp_path, rng):
        """run_partitioned_cohort in process: partition 0 returns the
        cohort summary of the single-process sweep."""
        root = write_cohort_tree(tmp_path, rng, num_subjects=3)
        my_flags = decoding.DecodingOptions().set_from_dict(dict(LINEAR))
        subjects = cohort.discover_subjects(root, [])
        lambdas = [1e-5, 1e-2]
        part_dir = str(tmp_path / 'parts')
        res1, summary1 = cohort.run_partitioned_cohort(
            my_flags, subjects, lambdas, partition_index=1,
            num_partitions=2, partition_dir=part_dir, device='cpu')
        assert summary1 is None and list(res1) == ['subject01']
        res0, (mean, std) = cohort.run_partitioned_cohort(
            my_flags, subjects, lambdas, partition_index=0,
            num_partitions=2, partition_dir=part_dir,
            cohort_csv_file=str(tmp_path / 'c.csv'), device='cpu')
        assert list(res0) == ['subject00', 'subject02']
        _, (want_mean, want_std) = cohort.run_cohort_sweep(
            my_flags, subjects, lambdas, device='cpu')
        np.testing.assert_allclose(mean, want_mean, atol=1e-6)
        np.testing.assert_allclose(std, want_std, atol=1e-6)
        assert os.path.exists(tmp_path / 'c.csv')

    def test_jax_partition_joins_in_the_port_driver(self, tmp_path, rng):
        """A JAX process sweeps partition 1, the port partition 0 and
        joins: the JAX single-process summary within 1e-6."""
        from telluride_decoding_tpu.cli import cohort as jax_cohort
        from telluride_decoding_tpu.cli import decoding as jax_decoding
        root = write_cohort_tree(tmp_path, rng, num_subjects=3)
        subjects = cohort.discover_subjects(root, [])
        lambdas = [1e-5, 1e-2]
        part_dir = str(tmp_path / 'parts')
        jax_flags = jax_decoding.DecodingOptions().set_from_dict(
            dict(LINEAR))
        jax_cohort.run_partitioned_cohort(
            jax_flags, subjects, lambdas, partition_index=1,
            num_partitions=2, partition_dir=part_dir,
            subject_parallel=False)
        _, (mean, std) = cohort.run_partitioned_cohort(
            decoding.DecodingOptions().set_from_dict(dict(LINEAR)),
            subjects, lambdas, partition_index=0, num_partitions=2,
            partition_dir=part_dir, device='cpu')
        _, (want_mean, want_std) = jax_cohort.run_cohort_sweep(
            jax_flags, subjects, lambdas, subject_parallel=False)
        np.testing.assert_allclose(mean, want_mean, atol=1e-6)
        np.testing.assert_allclose(std, want_std, atol=1e-6)

    def test_over_partitioned_cohort_joins(self, tmp_path, rng):
        """More partitions than subjects: the empty shard writes a zero
        part and the join still covers every subject."""
        root = write_cohort_tree(tmp_path, rng, num_subjects=2)
        my_flags = decoding.DecodingOptions().set_from_dict(dict(LINEAR))
        subjects = cohort.discover_subjects(root, [])
        part_dir = str(tmp_path / 'parts')
        for idx in (2, 1):
            res, summary = cohort.run_partitioned_cohort(
                my_flags, subjects, [1e-3], partition_index=idx,
                num_partitions=3, partition_dir=part_dir, device='cpu')
            assert summary is None
            assert len(res) == (0 if idx == 2 else 1)
        _, (mean, _) = cohort.run_partitioned_cohort(
            my_flags, subjects, [1e-3], partition_index=0,
            num_partitions=3, partition_dir=part_dir, device='cpu')
        _, (want_mean, _) = cohort.run_cohort_sweep(
            my_flags, subjects, [1e-3], device='cpu')
        np.testing.assert_allclose(mean, want_mean, atol=1e-6)
        with open(multihost.part_path(part_dir, 2)) as f:
            assert json.load(f)['subjects'] == []
