"""The whole-cohort sweep (multi_subject_sweep, cli/cohort.py) of the
PyTorch port vs the JAX package.

Both packages read the same tiny cohorts of TFRecord directories (the
JAX suite's ``write_cohort_tree``: 2-5 subjects of 3 ragged trials of
about 400 frames, 4 EEG channels, a planted lag-stacked TRF with post
context 4; a latent-source cohort for CCA) on the CPU. Tolerances:

  * per-subject grids, cohort means and stds: 1e-4 absolute, the sweep
    engine's bound (tests/test_torch_sweep.py); the cohort CSV's lambda
    column exactly;
  * the port's streaming loader against its eager loader: bit for bit,
    as the JAX suite pins for its own two loaders;
  * the lambda = 0 row of a rank-deficient subject (the eig retry):
    5e-4 absolute, test_torch_sweep.py's bound for an exactly singular
    covariance (its null eigenvalue rounds to about 1e-7 in float32 in
    both packages, above the eig program's 1e-12 cut).
"""

import csv
import dataclasses
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from telluride_decoding_tpu.cli import cohort as jax_cohort
from telluride_decoding_tpu.cli import decoding as jax_decoding
from telluride_decoding_tpu.data import records
from telluride_decoding_tpu.sweep import engine as jax_engine
from telluride_decoding_torch.cli import cohort, decoding
from telluride_decoding_torch.ops.lagstack import lag_stack_np
from telluride_decoding_torch.sweep import engine

from conftest import write_cohort_tree

R_TOL = 1e-4
SINGULAR_TOL = 5e-4
LAMBDAS = [1e-5, 1e-2, 10.0]
LINEAR = dict(input_field='eeg', output_field='intensity', pre_context=0,
              post_context=4, dnn_regressor='linear',
              train_file_pattern='allbut', shuffle_buffer_size=0)
CCA = dict(input_field='eeg', output_field='ones',
           input2_field='intensity', dnn_regressor='cca', cca_dimensions=2,
           pre_context=0, post_context=2, input2_pre_context=1,
           input2_post_context=1, train_file_pattern='allbut',
           shuffle_buffer_size=0)


def _options(module, **values):
    return module.DecodingOptions().set_from_dict(dict(values))


def _write_cca_cohort(tmp_path, rng, num_subjects=2, trials=3):
    """Subjects whose eeg and intensity share two latent sources."""
    root = tmp_path / 'cca_cohort'
    latent_w = rng.randn(2, 2).astype(np.float32)
    for s in range(num_subjects):
        d = root / ('subject%02d' % s)
        d.mkdir(parents=True)
        for t in range(trials):
            n = 300 + 11 * t + 5 * s
            latent = rng.randn(n, 2).astype(np.float32)
            eeg = np.concatenate([latent + 0.2 * rng.randn(n, 2),
                                  rng.randn(n, 3)], axis=1)
            intensity = latent @ latent_w + 0.2 * rng.randn(n, 2)
            records.convert_data_to_tfrecords(
                {'eeg': eeg.astype(np.float32),
                 'intensity': intensity.astype(np.float32)},
                str(d / ('trial%02d.tfrecords' % t)))
    return str(root)


def _cohort_for(family, tmp_path, rng, **kwargs):
    if family == 'cca':
        return _write_cca_cohort(tmp_path, rng, **kwargs), CCA
    return write_cohort_tree(tmp_path, rng, **kwargs), LINEAR


def _assert_results_close(got, want, tol=R_TOL):
    assert list(got) == list(want)
    for name in want:
        assert got[name].correlations.shape == \
            want[name].correlations.shape, name
        np.testing.assert_allclose(got[name].correlations,
                                   want[name].correlations, rtol=0,
                                   atol=tol, err_msg=name)
        np.testing.assert_array_equal(got[name].lambdas,
                                      want[name].lambdas)
        assert got[name].test_files == want[name].test_files


def _assert_results_equal(got, want):
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name].correlations,
                                      want[name].correlations,
                                      err_msg=name)


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def _assert_csv_close(got_path, want_path, header=False):
    """Same rows; the lambda column exactly, the numbers within R_TOL."""
    got, want = _read_csv(got_path), _read_csv(want_path)
    if header:
        assert got[0] == want[0]
        got, want = got[1:], want[1:]
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose(np.asarray([r[1:] for r in got], float),
                               np.asarray([r[1:] for r in want], float),
                               rtol=0, atol=R_TOL)


# -- discover_subjects -------------------------------------------------------


def test_discover_subjects_matches_jax(tmp_path, rng):
    root = write_cohort_tree(tmp_path, rng)
    found = cohort.discover_subjects(root, [])
    assert found == jax_cohort.discover_subjects(root, [])
    assert sorted(found) == ['subject00', 'subject01', 'subject02']
    explicit = [os.path.join(root, 'subject01')]
    assert cohort.discover_subjects(None, explicit) == \
        jax_cohort.discover_subjects(None, explicit)
    # Explicit directories come first and win over --cohort_dir's.
    mixed = [os.path.join(root, 'subject02')]
    assert cohort.discover_subjects(root, mixed) == \
        jax_cohort.discover_subjects(root, mixed)
    with pytest.raises(ValueError, match='No subjects'):
        cohort.discover_subjects(None, [])


def test_duplicate_subject_basenames_raise(tmp_path):
    a = tmp_path / 'sessA' / 's01'
    b = tmp_path / 'sessB' / 's01'
    a.mkdir(parents=True)
    b.mkdir(parents=True)
    with pytest.raises(ValueError, match='share the subject name'):
        cohort.discover_subjects(None, [str(a), str(b)])
    # The same path twice is not a collision.
    assert cohort.discover_subjects(None, [str(a), str(a)]) == \
        {'s01': str(a)}


# -- the engine --------------------------------------------------------------


def _raw_subjects(seed, num_subjects=3, channels=4, post=4):
    """{name: (raw xs, ys)} in the ContextSpec layout (x has n + post
    rows, y has n), ragged across trials and subjects."""
    rng = np.random.RandomState(seed)
    w = rng.randn(channels * (post + 1), 1).astype(np.float32)
    subjects = {}
    for s in range(num_subjects):
        xs, ys = [], []
        for t in range(3 + s % 2):
            n = 300 + 17 * t + 9 * s
            x = rng.randn(n + post, channels).astype(np.float32)
            y = lag_stack_np(x, 0, post)[:n] @ w + 0.3 * rng.randn(n, 1)
            xs.append(x)
            ys.append(y.astype(np.float32))
        subjects['s%d' % s] = (xs, ys)
    return subjects


@pytest.mark.parametrize('form', ['dict', 'list'])
@pytest.mark.parametrize('with_context', [True, False])
def test_multi_subject_ridge_matches_jax(form, with_context):
    subjects = _raw_subjects(0)
    ctx = engine.ContextSpec(0, 4, 0, 0)
    if not with_context:
        subjects = {name: ([lag_stack_np(x, 0, 4)[:y.shape[0]]
                            for x, y in zip(xs, ys)], ys)
                    for name, (xs, ys) in subjects.items()}
    arg = subjects if form == 'dict' else list(subjects.items())
    got = engine.multi_subject_sweep(
        arg, LAMBDAS, context=ctx if with_context else None, device='cpu')
    want = jax_engine.multi_subject_sweep(
        arg, LAMBDAS,
        context=jax_engine.ContextSpec(*ctx) if with_context else None)
    _assert_results_close(got, want)
    for got_stat, want_stat in zip(engine.cohort_summary(got),
                                   jax_engine.cohort_summary(want)):
        np.testing.assert_allclose(got_stat, want_stat, rtol=0, atol=R_TOL)


def test_multi_subject_cca_matches_jax():
    rng = np.random.RandomState(3)
    subjects = {}
    for s in range(3):
        mix = rng.randn(2, 3)
        xs, ys = [], []
        for t in range(4):
            n = 250 + 13 * t + 7 * s
            latent = rng.randn(n, 2)
            xs.append(np.concatenate([latent + 0.3 * rng.randn(n, 2),
                                      rng.randn(n, 4)], 1)
                      .astype(np.float32))
            ys.append((latent @ mix + 0.3 * rng.randn(n, 3))
                      .astype(np.float32))
        subjects['s%d' % s] = (xs, ys)
    got = engine.multi_subject_sweep(subjects, LAMBDAS, model='cca',
                                     dims=2, device='cpu')
    want = jax_engine.multi_subject_sweep(subjects, LAMBDAS, model='cca',
                                          dims=2)
    _assert_results_close(got, want)
    assert np.all(engine.cohort_summary(got)[0][:2] > 0.5)


def test_shared_shapes_pad_every_subject(monkeypatch):
    """Every subject reaches the moments with the cohort's (max files,
    max common frames), in common units under a context."""
    subjects = _raw_subjects(1)
    seen = []
    real = engine.per_file_stats

    def spy(xs, ys, want_syy, **kwargs):
        seen.append((kwargs['pad_files_to'], kwargs['pad_frames_to']))
        return real(xs, ys, want_syy, **kwargs)

    monkeypatch.setattr(engine, 'per_file_stats', spy)
    engine.multi_subject_sweep(subjects, LAMBDAS,
                               context=engine.ContextSpec(0, 4, 0, 0),
                               device='cpu')
    max_files = max(len(xs) for xs, _ in subjects.values())
    max_frames = max(y.shape[0] for _, ys in subjects.values() for y in ys)
    assert seen == [(max_files, max_frames)] * len(subjects)
    seen.clear()
    engine.multi_subject_sweep(subjects, LAMBDAS, shared_shapes=False,
                               context=engine.ContextSpec(0, 4, 0, 0),
                               device='cpu')
    assert seen == [(None, None)] * len(subjects)


def test_lazy_iterator_requires_pads():
    gen = iter([('s0', ([np.zeros((10, 2), np.float32)] * 2,
                        [np.zeros((10, 1), np.float32)] * 2))])
    with pytest.raises(ValueError, match='lazy subject iterable'):
        engine.multi_subject_sweep(gen, [1e-3], device='cpu')
    with pytest.raises(ValueError, match='lazy subject iterable'):
        engine.multi_subject_sweep(gen, [1e-3], pad_files_to=2,
                                   device='cpu')
    with pytest.raises(ValueError, match='lazy subject iterable'):
        jax_engine.multi_subject_sweep(gen, [1e-3])


def test_lazy_iterator_is_consumed_two_deep(monkeypatch):
    """The depth-2 pipeline: subject k is read back after subject k+1
    was taken from the iterable (and never later), and the results
    equal those of the same subjects passed as a dict."""
    subjects = _raw_subjects(2, num_subjects=5)
    ctx = engine.ContextSpec(0, 4, 0, 0)
    yielded = []
    taken_at_finalize = []
    real = engine._finalize_sweep

    def spy(inflight, timer=None):
        taken_at_finalize.append(len(yielded))
        return real(inflight, timer)

    monkeypatch.setattr(engine, '_finalize_sweep', spy)

    def gen():
        for name, arrays in subjects.items():
            yielded.append(name)
            yield name, arrays

    pads = (max(len(xs) for xs, _ in subjects.values()),
            max(y.shape[0] for _, ys in subjects.values() for y in ys))
    got = engine.multi_subject_sweep(gen(), LAMBDAS, context=ctx,
                                     pad_files_to=pads[0],
                                     pad_frames_to=pads[1], device='cpu')
    assert taken_at_finalize == [2, 3, 4, 5, 5]
    _assert_results_equal(got, engine.multi_subject_sweep(
        subjects, LAMBDAS, context=ctx, device='cpu'))
    want = jax_engine.multi_subject_sweep(
        iter(subjects.items()), LAMBDAS,
        context=jax_engine.ContextSpec(*ctx), pad_files_to=pads[0],
        pad_frames_to=pads[1])
    _assert_results_close(got, want)


def test_subject_beyond_the_declared_pads():
    """A streamed subject with more files and frames than the pads
    computes at its own shape: equal to its sweep alone."""
    subjects = _raw_subjects(4, num_subjects=3)
    ctx = engine.ContextSpec(0, 4, 0, 0)
    small = (3, 300)   # Below subject s1's 4 files and s2's frames.
    got = engine.multi_subject_sweep(iter(subjects.items()), LAMBDAS,
                                     context=ctx, pad_files_to=small[0],
                                     pad_frames_to=small[1], device='cpu')
    for name, (xs, ys) in subjects.items():
        alone = engine.ridge_jackknife_sweep(
            xs, ys, LAMBDAS, context=ctx, pad_files_to=small[0],
            pad_frames_to=small[1], device='cpu')
        np.testing.assert_array_equal(got[name].correlations,
                                      alone.correlations)
        assert got[name].correlations.shape == (len(LAMBDAS), len(xs))
    want = jax_engine.multi_subject_sweep(
        iter(subjects.items()), LAMBDAS,
        context=jax_engine.ContextSpec(*ctx), pad_files_to=small[0],
        pad_frames_to=small[1])
    _assert_results_close(got, want)


def test_rank_deficient_subject_takes_the_eig_retry_alone(monkeypatch):
    """A duplicated channel with lambda = 0 breaks one subject's
    Cholesky grid: only that subject reruns through the eig program, its
    groupmates keep their Cholesky results, and every grid matches the
    JAX package's."""
    subjects = _raw_subjects(5, num_subjects=3)
    xs, ys = subjects['s1']
    for x in xs:
        x[:, 3] = x[:, 2]
    lambdas = [0.0, 1e-3, 1.0]
    ctx = engine.ContextSpec(0, 4, 0, 0)
    retried = []
    real = engine._ridge_eig_program

    def spy(stacked, total, lams):
        retried.append(int(stacked.count.shape[0]))
        return real(stacked, total, lams)

    monkeypatch.setattr(engine, '_ridge_eig_program', spy)
    got = engine.multi_subject_sweep(subjects, lambdas, context=ctx,
                                     device='cpu')
    assert retried == [len(subjects['s1'][0])]
    pads = (max(len(xs) for xs, _ in subjects.values()),
            max(y.shape[0] for _, ys in subjects.values() for y in ys))
    monkeypatch.setattr(engine, '_ridge_eig_program', real)
    for name in ('s0', 's2'):
        alone = engine.ridge_jackknife_sweep(
            *subjects[name], lambdas, context=ctx, pad_files_to=pads[0],
            pad_frames_to=pads[1], device='cpu')
        np.testing.assert_array_equal(got[name].correlations,
                                      alone.correlations)
    assert np.isfinite(got['s1'].correlations).all()
    want = jax_engine.multi_subject_sweep(
        subjects, lambdas, context=jax_engine.ContextSpec(*ctx))
    for name in subjects:
        np.testing.assert_allclose(got[name].correlations[0],
                                   want[name].correlations[0], rtol=0,
                                   atol=SINGULAR_TOL, err_msg=name)
        np.testing.assert_allclose(got[name].correlations[1:],
                                   want[name].correlations[1:], rtol=0,
                                   atol=R_TOL, err_msg=name)


def test_subject_parallel_runs_serially():
    subjects = _raw_subjects(6)
    ctx = engine.ContextSpec(0, 4, 0, 0)
    _assert_results_equal(
        engine.multi_subject_sweep(subjects, LAMBDAS, context=ctx,
                                   subject_parallel=True, device='cpu'),
        engine.multi_subject_sweep(subjects, LAMBDAS, context=ctx,
                                   device='cpu'))


def test_cohort_summary_matches_jax(rng):
    results = {
        name: engine.SweepResult(rng.randn(4, 3 + i), np.arange(4.0),
                                 ['f'] * (3 + i))
        for i, name in enumerate(('a', 'b', 'c'))}
    for got, want in zip(engine.cohort_summary(results),
                         jax_engine.cohort_summary(results)):
        np.testing.assert_array_equal(got, want)


# -- the driver's functions --------------------------------------------------


@pytest.mark.parametrize('family', ['linear', 'cca'])
def test_run_cohort_sweep_matches_jax(tmp_path, rng, family):
    root, opts = _cohort_for(family, tmp_path, rng)
    subjects = cohort.discover_subjects(root, [])
    out = {}
    for name, module, kwargs in (('jax', jax_cohort, {}),
                                 ('torch', cohort, {'device': 'cpu'})):
        d = tmp_path / name
        my_flags = _options(
            jax_decoding if module is jax_cohort else decoding, **opts)
        out[name] = module.run_cohort_sweep(
            my_flags, subjects, LAMBDAS, subject_parallel=False,
            cohort_csv_file=str(d / 'cohort.csv'),
            results_csv_file=str(d / 'per_subject.csv'), **kwargs)
    (got, (mean, std)), (want, (want_mean, want_std)) = \
        out['torch'], out['jax']
    _assert_results_close(got, want)
    np.testing.assert_allclose(mean, want_mean, rtol=0, atol=R_TOL)
    np.testing.assert_allclose(std, want_std, rtol=0, atol=R_TOL)
    _assert_csv_close(tmp_path / 'torch' / 'cohort.csv',
                      tmp_path / 'jax' / 'cohort.csv', header=True)
    per_subject = sorted(os.listdir(tmp_path / 'jax'))
    assert sorted(os.listdir(tmp_path / 'torch')) == per_subject
    assert len(per_subject) == len(subjects) + 1
    for name in per_subject:
        if name != 'cohort.csv':
            _assert_csv_close(tmp_path / 'torch' / name,
                              tmp_path / 'jax' / name)
    if family == 'linear':
        # The planted model: small lambdas recover it on every subject.
        assert np.all(mean[:2] > 0.97) and mean[2] < mean[0]
    else:
        assert np.all(mean[:2] > 0.5)


def test_cohort_csv_and_plot(tmp_path, rng):
    root = write_cohort_tree(tmp_path, rng, num_subjects=2)
    cohort.run_cohort_sweep(
        _options(decoding, **LINEAR), cohort.discover_subjects(root, []),
        LAMBDAS, cohort_csv_file=str(tmp_path / 'out' / 'c.csv'),
        cohort_plot_file=str(tmp_path / 'plots' / 'c.png'), device='cpu')
    rows = _read_csv(tmp_path / 'out' / 'c.csv')
    assert rows[0] == ['lambda', 'mean', 'std'] and len(rows) == 4
    assert [r[0] for r in rows[1:]] == ['1e-05', '0.01', '10']
    assert os.path.getsize(tmp_path / 'plots' / 'c.png') > 0


@pytest.mark.parametrize('family', ['linear', 'cca'])
def test_streaming_equals_eager_bit_for_bit(tmp_path, rng, family):
    root, opts = _cohort_for(family, tmp_path, rng, num_subjects=4)
    subjects = cohort.discover_subjects(root, [])
    my_flags = _options(decoding, **opts)
    eager, (mean_e, std_e) = cohort.run_cohort_sweep(
        my_flags, subjects, LAMBDAS, streaming=False, device='cpu')
    stream, (mean_s, std_s) = cohort.run_cohort_sweep(
        my_flags, subjects, LAMBDAS, streaming=True, device='cpu')
    _assert_results_equal(stream, eager)
    np.testing.assert_array_equal(mean_s, mean_e)
    np.testing.assert_array_equal(std_s, std_e)


def test_streaming_environment_knob(tmp_path, rng, monkeypatch):
    """TDT_STREAMING_COHORT=0 loads eagerly unless streaming is asked
    for; the two give the same numbers."""
    root = write_cohort_tree(tmp_path, rng, num_subjects=2)
    subjects = cohort.discover_subjects(root, [])
    prescans = []
    real = cohort.prescan_cohort
    monkeypatch.setattr(cohort, 'prescan_cohort',
                        lambda *a: prescans.append(1) or real(*a))
    monkeypatch.setenv('TDT_STREAMING_COHORT', '0')
    eager, _ = cohort.run_cohort_sweep(_options(decoding, **LINEAR),
                                       subjects, LAMBDAS, device='cpu')
    assert prescans == []
    stream, _ = cohort.run_cohort_sweep(_options(decoding, **LINEAR),
                                        subjects, LAMBDAS, streaming=True,
                                        device='cpu')
    assert prescans == [1]
    _assert_results_equal(stream, eager)


@pytest.mark.parametrize('family', ['linear', 'cca'])
def test_prescan_matches_eager_shapes_and_jax(tmp_path, rng, family):
    root, opts = _cohort_for(family, tmp_path, rng, num_subjects=3)
    subjects = cohort.discover_subjects(root, [])
    my_flags = _options(decoding, **opts)
    pads = cohort.prescan_cohort(subjects, my_flags)
    assert pads == jax_cohort.prescan_cohort(
        subjects, _options(jax_decoding, **opts))
    loaded, context = cohort.load_cohort(subjects, my_flags, device='cpu')
    x_post = context.x_post if context is not None else 0
    assert pads == (max(len(xs) for xs, _ in loaded.values()),
                    max(x.shape[0] for xs, _ in loaded.values()
                        for x in xs) - x_post)


def test_prescan_ignores_input_offset(tmp_path, rng):
    root = write_cohort_tree(tmp_path, rng, num_subjects=2)
    subjects = cohort.discover_subjects(root, [])
    base = _options(decoding, **LINEAR)
    shifted = dataclasses.replace(base, input_offset=26)
    pads = cohort.prescan_cohort(subjects, shifted)
    assert pads == cohort.prescan_cohort(subjects, base)
    assert pads == jax_cohort.prescan_cohort(
        subjects, _options(jax_decoding, **dict(LINEAR, input_offset=26)))
    loaded, context = cohort.load_cohort(subjects, shifted, device='cpu')
    assert pads == (max(len(xs) for xs, _ in loaded.values()),
                    max(x.shape[0] for xs, _ in loaded.values()
                        for x in xs) - context.x_post)


def test_prescan_refuses_corrupt_records(tmp_path, rng):
    root = write_cohort_tree(tmp_path, rng, num_subjects=2)
    path = os.path.join(root, 'subject01', 'trial01.tfrecords')
    with open(path, 'r+b') as f:
        f.seek(40)
        f.write(b'\xff' * 8)
    subjects = cohort.discover_subjects(root, [])
    assert cohort.prescan_cohort(subjects, _options(decoding, **LINEAR)) \
        is None
    assert jax_cohort.prescan_cohort(
        subjects, _options(jax_decoding, **LINEAR)) is None


def test_field_spec_falls_back_to_eager(tmp_path, rng):
    """On-the-fly field specs may change stream lengths, so the prescan
    refuses and run_cohort_sweep loads eagerly."""
    root = write_cohort_tree(tmp_path, rng, num_subjects=2)
    subjects = cohort.discover_subjects(root, [])
    spec = dict(LINEAR,
                input_field='eeg(highpass_cutoff=0.5;highpass_order=2)')
    my_flags = _options(decoding, **spec)
    assert cohort.prescan_cohort(subjects, my_flags) is None
    assert jax_cohort.prescan_cohort(
        subjects, _options(jax_decoding, **spec)) is None
    results, (mean, _) = cohort.run_cohort_sweep(
        my_flags, subjects, [1e-4], streaming=True, device='cpu')
    assert sorted(results) == sorted(subjects)
    assert np.isfinite(mean).all()


def test_device_context_equals_host_stacking(tmp_path, rng, monkeypatch):
    root = write_cohort_tree(tmp_path, rng, num_subjects=2)
    subjects = cohort.discover_subjects(root, [])
    out = {}
    for env in ('1', '0'):
        monkeypatch.setenv('TDT_DEVICE_CONTEXT', env)
        out[env], _ = cohort.run_cohort_sweep(
            _options(decoding, **LINEAR), subjects, LAMBDAS, device='cpu')
    _assert_results_close(out['0'], out['1'])
    jax_host, _ = jax_cohort.run_cohort_sweep(
        _options(jax_decoding, **LINEAR), subjects, LAMBDAS,
        subject_parallel=False)
    _assert_results_close(out['0'], jax_host)


def test_load_cohort_layouts(tmp_path, rng, monkeypatch):
    """Raw streams with the ContextSpec by default, host lag stacks and
    no spec with TDT_DEVICE_CONTEXT=0; both as the JAX loader's."""
    root = write_cohort_tree(tmp_path, rng, num_subjects=2)
    subjects = cohort.discover_subjects(root, [])
    for env in ('1', '0'):
        monkeypatch.setenv('TDT_DEVICE_CONTEXT', env)
        got, ctx = cohort.load_cohort(subjects, _options(decoding, **LINEAR),
                                      device='cpu')
        want, jax_ctx = jax_cohort.load_cohort(
            subjects, _options(jax_decoding, **LINEAR))
        assert (ctx is None) == (env == '0')
        if ctx is not None:
            assert tuple(ctx) == tuple(jax_ctx) == (0, 4, 0, 0)
        assert list(got) == list(want)
        for name in want:
            for a, b in zip(got[name][0] + got[name][1],
                            want[name][0] + want[name][1]):
                assert isinstance(a, np.ndarray)
                np.testing.assert_array_equal(a, b)


# -- iter_cohort ---------------------------------------------------------------


def test_iter_cohort_order_and_no_prefetch(tmp_path, rng):
    root = write_cohort_tree(tmp_path, rng, num_subjects=3)
    subjects = cohort.discover_subjects(root, [])
    my_flags = _options(decoding, **LINEAR)
    plain = list(cohort.iter_cohort(subjects, my_flags, prefetch=False))
    assert [n for n, _ in plain] == list(subjects)
    fetched = list(cohort.iter_cohort(subjects, my_flags))
    assert [n for n, _ in fetched] == list(subjects)
    for (_, (xs, ys)), (_, (xs_p, ys_p)) in zip(plain, fetched):
        for a, b in zip(xs + ys, xs_p + ys_p):
            # The worker hands the consumer host arrays, never tensors.
            assert isinstance(b, np.ndarray)
            np.testing.assert_array_equal(a, b)


def test_iter_cohort_prefetch_error_propagates(tmp_path):
    bad = tmp_path / 'empty_subject'
    bad.mkdir()
    with pytest.raises(ValueError, match='empty list of data files'):
        list(cohort.iter_cohort({'bad': str(bad)},
                                _options(decoding, **LINEAR)))


def test_prefetch_thread_exits_on_abandoned_iteration(tmp_path, rng):
    root = write_cohort_tree(tmp_path, rng, num_subjects=4)
    subjects = cohort.discover_subjects(root, [])
    gen = cohort.iter_cohort(subjects, _options(decoding, **LINEAR))
    next(gen)                   # The worker now reads ahead.
    gen.close()                 # The consumer abandons the cohort.
    deadline = time.time() + 10
    alive = True
    while alive and time.time() < deadline:
        alive = any(t.name == 'tdt-cohort-prefetch' and t.is_alive()
                    for t in threading.enumerate())
        time.sleep(0.05)
    assert not alive, 'prefetch thread still blocked after close()'


def test_iter_cohort_reads_ahead_one_subject(tmp_path, rng, monkeypatch):
    """The queue holds one subject: while the consumer holds subject k
    the worker has read at most subjects k+1 and k+2 (one queued, one
    waiting to be put)."""
    root = write_cohort_tree(tmp_path, rng, num_subjects=5)
    subjects = cohort.discover_subjects(root, [])
    loaded = []
    real = cohort._load_subject

    def spy(name, *args):
        loaded.append(name)
        return real(name, *args)

    monkeypatch.setattr(cohort, '_load_subject', spy)
    names = list(subjects)
    for k, (name, _) in enumerate(cohort.iter_cohort(
            subjects, _options(decoding, **LINEAR))):
        assert name == names[k]
        time.sleep(0.2)           # Let the worker run ahead.
        assert k + 1 <= len(loaded) <= k + 3


# -- main ----------------------------------------------------------------------


def _table(stdout):
    """The printed summary: its header and (lambda, mean, std, best)
    rows."""
    lines = stdout[stdout.index('Cohort sweep over'):].strip().splitlines()
    rows = []
    for line in lines[1:]:
        parts = line.split()
        rows.append((parts[1], float(parts[4]), float(parts[6]),
                     line.endswith('<-- best')))
    return lines[0], rows


def test_cli_main_matches_jax_cli(tmp_path, rng, cpu_subprocess_env):
    """Both entry points end to end in subprocesses: the printed table
    (lambda column and best marker exactly, numbers within 1e-4), the
    cohort CSV and the per-subject CSVs. An untouched --dnn_regressor
    means linear in both."""
    root = write_cohort_tree(tmp_path, rng, num_subjects=2)
    out = {}
    for name, module, extra in (
            ('jax', 'telluride_decoding_tpu.cli.cohort', []),
            ('torch', 'telluride_decoding_torch.cli.cohort',
             ['--device', 'cpu'])):
        d = tmp_path / name
        proc = subprocess.run(
            [sys.executable, '-m', module, '--cohort_dir', root,
             '--input_field', 'eeg', '--output_field', 'intensity',
             '--post_context', '4', '--regularization_list', '1e-5,1e-2,10',
             '--cohort_csv_file', str(d / 'c.csv'),
             '--results_csv_file', str(d / 'per.csv')] + extra,
            env=cpu_subprocess_env, capture_output=True, text=True,
            timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[name] = _table(proc.stdout)
    assert out['torch'][0] == out['jax'][0] == \
        'Cohort sweep over 2 subjects, 3 lambdas:'
    got, want = out['torch'][1], out['jax'][1]
    assert [(r[0], r[3]) for r in got] == [(r[0], r[3]) for r in want]
    np.testing.assert_allclose([r[1:3] for r in got],
                               [r[1:3] for r in want], rtol=0, atol=R_TOL)
    _assert_csv_close(tmp_path / 'torch' / 'c.csv',
                      tmp_path / 'jax' / 'c.csv', header=True)
    for subject in ('subject00', 'subject01'):
        _assert_csv_close(tmp_path / 'torch' / ('per_%s.csv' % subject),
                          tmp_path / 'jax' / ('per_%s.csv' % subject))


def test_main_flags(tmp_path, rng, monkeypatch, capsys):
    """--subject_dir repeats, --nostreaming_cohort loads eagerly, an
    untouched --streaming_cohort defers to TDT_STREAMING_COHORT, and
    --dnn_regressor cca runs the CCA grid."""
    root = write_cohort_tree(tmp_path, rng, num_subjects=3)
    calls = []
    real = cohort.run_cohort_sweep

    def spy(my_flags, subjects, lambdas, **kwargs):
        calls.append((my_flags.dnn_regressor, sorted(subjects),
                      kwargs['streaming'], kwargs['device']))
        return real(my_flags, subjects, lambdas, **kwargs)

    monkeypatch.setattr(cohort, 'run_cohort_sweep', spy)
    base = ['--input_field', 'eeg', '--output_field', 'intensity',
            '--post_context', '4', '--regularization_list', '1e-3',
            '--device', 'cpu']
    two = ['--subject_dir', os.path.join(root, 'subject00'),
           '--subject_dir', os.path.join(root, 'subject02')]
    assert cohort.main(base + two + ['--nostreaming_cohort']) == 0
    assert cohort.main(base + ['--cohort_dir', root]) == 0
    assert cohort.main(base + ['--cohort_dir', root, '--streaming_cohort',
                               '--dnn_regressor', 'linear_with_bias']) == 0
    assert calls == [
        ('linear', ['subject00', 'subject02'], False, 'cpu'),
        ('linear', ['subject00', 'subject01', 'subject02'], None, 'cpu'),
        ('linear_with_bias', ['subject00', 'subject01', 'subject02'],
         True, 'cpu')]
    assert 'Cohort sweep over 2 subjects, 1 lambdas:' in \
        capsys.readouterr().out


def test_main_cca_family(tmp_path, rng, capsys):
    root = _write_cca_cohort(tmp_path, rng)
    assert cohort.main([
        '--cohort_dir', root, '--dnn_regressor', 'cca', '--input_field',
        'eeg', '--output_field', 'ones', '--input2_field', 'intensity',
        '--post_context', '2', '--input2_pre_context', '1',
        '--input2_post_context', '1', '--cca_dimensions', '2',
        '--regularization_list', '1e-2,1', '--cohort_csv_file',
        str(tmp_path / 'c.csv'), '--device', 'cpu']) == 0
    _, rows = _table(capsys.readouterr().out)
    _, (want_mean, want_std) = jax_cohort.run_cohort_sweep(
        _options(jax_decoding, **CCA), cohort.discover_subjects(root, []),
        [1e-2, 1.0], subject_parallel=False)
    np.testing.assert_allclose([r[1] for r in rows], want_mean, rtol=0,
                               atol=R_TOL)
    np.testing.assert_allclose([r[2] for r in rows], want_std, rtol=0,
                               atol=R_TOL)


def test_tf_family_raises_the_jax_message(tmp_path, rng):
    root = write_cohort_tree(tmp_path, rng, num_subjects=1)
    subjects = cohort.discover_subjects(root, [])
    with pytest.raises(ValueError) as got:
        cohort.run_cohort_sweep(
            _options(decoding, **dict(LINEAR, dnn_regressor='tf')),
            subjects, [1e-3], device='cpu')
    with pytest.raises(ValueError) as want:
        jax_cohort.run_cohort_sweep(
            _options(jax_decoding, **dict(LINEAR, dnn_regressor='tf')),
            subjects, [1e-3])
    assert str(got.value) == str(want.value)


def test_coordinator_environment_raises(tmp_path, rng, monkeypatch):
    root = write_cohort_tree(tmp_path, rng, num_subjects=1)
    monkeypatch.setenv('TDT_COORDINATOR', 'localhost:1234')
    with pytest.raises(ValueError, match='TDT_COORDINATOR.*not ported'):
        cohort.main(['--cohort_dir', root, '--input_field', 'eeg',
                     '--output_field', 'intensity', '--device', 'cpu'])


def test_partitions_need_an_index(tmp_path, rng):
    root = write_cohort_tree(tmp_path, rng, num_subjects=2)
    with pytest.raises(ValueError, match='--partition_index'):
        cohort.main(['--cohort_dir', root, '--input_field', 'eeg',
                     '--output_field', 'intensity', '--num_partitions',
                     '2', '--device', 'cpu'])


def test_main_defaults_to_the_card(tmp_path, rng):
    if torch.cuda.is_available():
        pytest.skip('checks the error on a machine without a card')
    root = write_cohort_tree(tmp_path, rng, num_subjects=1)
    with pytest.raises(RuntimeError, match='No CUDA device'):
        cohort.main(['--cohort_dir', root, '--input_field', 'eeg',
                     '--output_field', 'intensity'])


def test_flags_cover_the_jax_driver():
    """Every flag of the JAX cohort driver parses here with its default;
    --dnn_regressor and --streaming_cohort default to None, which the
    driver reads as untouched (linear; the environment)."""
    parser = cohort.build_parser()
    ours = {a.dest for a in parser._actions}
    flags = jax_cohort.FLAGS
    for name in ('cohort_dir', 'subject_dir', 'cohort_csv_file',
                 'cohort_plot_file', 'subject_parallel', 'num_partitions',
                 'partition_index', 'partition_dir', 'partition_wait_s',
                 'regularization_list', 'results_csv_file',
                 'sweep_checkpoint_dir', 'pre_context', 'post_context',
                 'input_field', 'cca_dimensions'):
        assert name in ours, name
        assert parser.get_default(name) == flags[name].default, name
    assert flags['dnn_regressor'].default == 'fullyconnected'
    assert flags['streaming_cohort'].default is True
    assert parser.get_default('dnn_regressor') is None
    assert parser.get_default('streaming_cohort') is None
    assert parser.get_default('device') == 'cuda'
    args = parser.parse_args(['--nosubject_parallel', '--streaming_cohort',
                              '--sweep_checkpoint_dir', '/x'])
    assert (args.subject_parallel, args.streaming_cohort,
            args.sweep_checkpoint_dir) == (False, True, '/x')
