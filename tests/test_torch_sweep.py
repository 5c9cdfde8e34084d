"""The jackknife x lambda sweep engine and its checkpoints: the PyTorch
port vs the JAX package.

The same seeded numpy inputs (5-6 files of 200-600 ragged frames, 6-8
channels, post context 4, near zero mean as the z-scoring ingest gives)
go through both packages on the CPU. Tolerances:

  * per-file MomentStats: rtol 1e-5 / atol 1e-4, the JAX suite's own
    bound between its two regimes (float32 sums in another order);
  * held-out correlations: 1e-4 absolute, for every grid path
    (Cholesky, eig, shrinkage, CCA, the NaN -> eig retry);
  * the DC-offset case (mu/sigma = 100 on x and y, the JAX suite's
    boundary case): 2e-2 absolute. Uncentered float32 moments there
    cancel about five of the seven digits (sweep/engine.py:493-500), so
    each package is about 1e-2 off the true r (both report r above 1
    on some files) and the two differ by the order of their sums. The
    JAX suite's own gate, r > 0.95, holds in both.
  * lambda = 0 on an exactly singular covariance (the eig retry):
    5e-4 absolute on that row. The null eigenvalue comes out about 1e-7
    in float32 in both packages, above the eig program's 1e-12 cut, so
    the whitening scales rounding noise by about 3e3 there.
"""

import json
import os

import numpy as np
import pytest
import torch

from telluride_decoding_tpu.ops import covariance as jax_cov
from telluride_decoding_tpu.sweep import checkpoint as jax_checkpoint
from telluride_decoding_tpu.sweep import engine as jax_engine
from telluride_decoding_torch.ops import covariance
from telluride_decoding_torch.ops.lagstack import lag_stack_np
from telluride_decoding_torch.sweep import checkpoint, engine

STATS_TOL = dict(rtol=1e-5, atol=1e-4)
R_TOL = 1e-4
DC_TOL = 2e-2
SINGULAR_TOL = 5e-4
POST = 4


def _raw_corpus(seed, lengths=(230, 410, 360, 580, 300), channels=6,
                noise=0.5):
    """Raw EEG-like x per file and a planted target through a lag-stacked
    TRF (post context POST); returns (raw xs, ys)."""
    rng = np.random.RandomState(seed)
    w = rng.randn(channels * (POST + 1), 1).astype(np.float32)
    xs, ys = [], []
    for n in lengths:
        x = rng.randn(n, channels).astype(np.float32)
        y = lag_stack_np(x, 0, POST) @ w + noise * rng.randn(n, 1)
        xs.append(x)
        ys.append(y.astype(np.float32))
    return xs, ys


def _stacked_corpus(seed, **kwargs):
    xs, ys = _raw_corpus(seed, **kwargs)
    return [lag_stack_np(x, 0, POST) for x in xs], ys


def _cca_corpus(seed, lengths=(260, 330, 410, 290, 520, 380), dx=8,
                dy=3):
    """Files sharing two latent sources between x and y."""
    rng = np.random.RandomState(seed)
    mix_x = rng.randn(2, dx).astype(np.float32)
    mix_y = rng.randn(2, dy).astype(np.float32)
    xs, ys = [], []
    for n in lengths:
        latent = rng.randn(n, 2).astype(np.float32)
        xs.append((latent @ mix_x + rng.randn(n, dx)).astype(np.float32))
        ys.append((latent @ mix_y + rng.randn(n, dy)).astype(np.float32))
    return xs, ys


def _assert_stats_close(got, want):
    for name, g, w in zip(covariance.MomentStats._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **STATS_TOL)


# -- per-file statistics ------------------------------------------------------

REGIMES = {
    'batched_ragged': dict(batch_bytes=1 << 30),
    'batched_pad_frames': dict(batch_bytes=1 << 30, pad_frames_to=640),
    'streaming': dict(batch_bytes=0, frame_bucket=128),
}


@pytest.mark.parametrize('regime', sorted(REGIMES))
@pytest.mark.parametrize('pad_files_to', [None, 7])
def test_per_file_stats_matches_jax(regime, pad_files_to):
    xs, ys = _stacked_corpus(0)
    kwargs = dict(REGIMES[regime], want_syy=True, pad_files_to=pad_files_to)
    got = engine.per_file_stats(xs, ys, device='cpu', **kwargs)
    want = jax_engine.per_file_stats(xs, ys, **kwargs)
    assert got.count.shape[0] == (pad_files_to or len(xs))
    _assert_stats_close(got, want)


def test_per_file_stats_uniform_lengths_matches_jax():
    xs, ys = _stacked_corpus(1, lengths=(300,) * 5)
    got = engine.per_file_stats(xs, ys, want_syy=False, device='cpu')
    want = jax_engine.per_file_stats(xs, ys, want_syy=False)
    _assert_stats_close(got, want)
    np.testing.assert_array_equal(got.count.numpy(), 300.0)


@pytest.mark.parametrize('lengths', [(300,) * 5, (230, 410, 360, 580, 300)],
                         ids=['uniform', 'ragged'])
def test_per_file_stats_takes_tensors(lengths):
    """Tensors in give the statistics numpy arrays give."""
    xs, ys = _stacked_corpus(19, lengths=lengths)
    want = engine.per_file_stats(xs, ys, want_syy=True, device='cpu')
    got = engine.per_file_stats([torch.tensor(x) for x in xs],
                                [torch.tensor(y) for y in ys],
                                want_syy=True, device='cpu')
    for name, g, w in zip(covariance.MomentStats._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)


def _context_corpus(seed, ctx, lengths=(230, 410, 360, 580, 300), dx=6,
                    dy=2, extra_x_rows=3):
    """Raw streams in the ContextSpec layout (x keeps real rows past n,
    y pads with zeros) and the host-stacked equivalents."""
    rng = np.random.RandomState(seed)
    xs_raw, ys_raw, xs_host, ys_host = [], [], [], []
    for n in lengths:
        x_full = rng.randn(n + extra_x_rows, dx).astype(np.float32)
        x_raw = np.zeros((n + ctx.x_post, dx), np.float32)
        keep = min(x_full.shape[0], n + ctx.x_post)
        x_raw[:keep] = x_full[:keep]
        y_raw = np.zeros((n + ctx.y_post, dy), np.float32)
        y_raw[:n] = rng.randn(n, dy)
        xs_raw.append(x_raw)
        ys_raw.append(y_raw)
        xs_host.append(lag_stack_np(x_raw, ctx.x_pre, ctx.x_post)[:n])
        ys_host.append(lag_stack_np(y_raw, ctx.y_pre, ctx.y_post)[:n])
    return xs_raw, ys_raw, xs_host, ys_host


@pytest.mark.parametrize('batch_bytes', [1 << 30, 0],
                         ids=['device_context', 'host_fallback'])
@pytest.mark.parametrize('ctx', [(0, POST, 0, 0), (1, POST, 2, 1)],
                         ids=['x_only', 'x_and_y'])
def test_per_file_stats_context_matches_jax(batch_bytes, ctx):
    ctx_t = engine.ContextSpec(*ctx)
    xs_raw, ys_raw, xs_host, ys_host = _context_corpus(2, ctx_t)
    got = engine.per_file_stats(xs_raw, ys_raw, want_syy=True,
                                context=ctx_t, pad_files_to=6,
                                batch_bytes=batch_bytes, device='cpu')
    want = jax_engine.per_file_stats(xs_raw, ys_raw, want_syy=True,
                                     context=jax_engine.ContextSpec(*ctx),
                                     pad_files_to=6,
                                     batch_bytes=batch_bytes)
    _assert_stats_close(got, want)
    host = engine.per_file_stats(xs_host, ys_host, want_syy=True,
                                 pad_files_to=6, device='cpu')
    for name, g, h in zip(covariance.MomentStats._fields, got, host):
        np.testing.assert_allclose(g.numpy(), h.numpy(), err_msg=name,
                                   **STATS_TOL)


@pytest.mark.parametrize('ctx', [(0, POST, 0, 0), (1, POST, 2, 1)],
                         ids=['x_only', 'x_and_y'])
def test_streaming_context_equals_host_stack(ctx):
    """The bounded-memory regime stacks each raw file into its
    bucket-padded buffer: the moments equal, bit for bit, those of the
    same regime over the host-stacked files."""
    ctx_t = engine.ContextSpec(*ctx)
    xs_raw, ys_raw, xs_host, ys_host = _context_corpus(6, ctx_t)
    got = engine.per_file_stats(xs_raw, ys_raw, want_syy=True,
                                context=ctx_t, batch_bytes=0,
                                frame_bucket=128, device='cpu')
    want = engine.per_file_stats(xs_host, ys_host, want_syy=True,
                                 batch_bytes=0, frame_bucket=128,
                                 device='cpu')
    for name, g, w in zip(covariance.MomentStats._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)


def test_per_file_stats_rejects_bad_layouts():
    xs, ys = _stacked_corpus(3)
    with pytest.raises(ValueError, match='5 x files but 4 y'):
        engine.per_file_stats(xs, ys[:4], want_syy=True, device='cpu')
    with pytest.raises(ValueError, match='must align'):
        engine.per_file_stats(xs, [y[:-1] for y in ys], want_syy=True,
                              device='cpu')
    ctx = engine.ContextSpec(0, POST, 0, 0)
    with pytest.raises(ValueError, match='context layout violated'):
        engine.per_file_stats(xs, ys, want_syy=True, context=ctx,
                              device='cpu')


def test_pad_and_stack_matches_jax():
    xs, _ = _stacked_corpus(4)
    got, got_mask = engine.pad_and_stack(xs, pad_frames_to=600,
                                         pad_files_to=7, device='cpu')
    want, want_mask = jax_engine.pad_and_stack(xs, pad_frames_to=600,
                                               pad_files_to=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


# -- held-out r from moments --------------------------------------------------

def test_linear_r_from_stats_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(450, 8).astype(np.float32)
    y = (x @ rng.randn(8, 2) + rng.randn(450, 2)).astype(np.float32)
    w = rng.randn(8, 2).astype(np.float32)
    b = rng.randn(2).astype(np.float32)
    got = engine._linear_r_from_stats(
        covariance.moments_from_arrays(torch.from_numpy(x),
                                       torch.from_numpy(y), want_syy=True),
        torch.from_numpy(w), torch.from_numpy(b))
    want = jax_engine._linear_r_from_stats(
        jax_cov.moments_from_arrays(x, y, want_syy=True), w, b)
    assert float(got) == pytest.approx(float(want), abs=R_TOL)
    dense = np.corrcoef(y[:, 0], x @ w[:, 0] + b[0])[0, 1]
    assert float(got) == pytest.approx(dense, abs=R_TOL)


def test_cca_r_from_stats_matches_jax():
    rng = np.random.RandomState(6)
    xs, ys = _cca_corpus(6, lengths=(400,))
    u = rng.randn(8).astype(np.float32)
    v = rng.randn(3).astype(np.float32)
    got = engine._cca_r_from_stats(
        covariance.moments_from_arrays(torch.from_numpy(xs[0]),
                                       torch.from_numpy(ys[0]),
                                       want_syy=True),
        torch.from_numpy(u), torch.from_numpy(v))
    want = jax_engine._cca_r_from_stats(
        jax_cov.moments_from_arrays(xs[0], ys[0], want_syy=True), u, v)
    assert float(got) == pytest.approx(float(want), abs=R_TOL)
    dense = np.corrcoef(xs[0] @ u, ys[0] @ v)[0, 1]
    assert float(got) == pytest.approx(dense, abs=R_TOL)


def test_r_from_stats_batches_over_files():
    """One call over [F] stats equals F single-file calls."""
    xs, ys = _stacked_corpus(7)
    stats = engine.per_file_stats(xs, ys, want_syy=True, device='cpu')
    rng = np.random.RandomState(7)
    w = torch.from_numpy(rng.randn(len(xs), xs[0].shape[1], 1)
                         .astype(np.float32))
    b = torch.from_numpy(rng.randn(len(xs), 1).astype(np.float32))
    batched = engine._linear_r_from_stats(stats, w, b)
    single = [engine._linear_r_from_stats(engine._tree_index(stats, f),
                                          w[f], b[f])
              for f in range(len(xs))]
    np.testing.assert_allclose(batched.numpy(), np.stack(single),
                               atol=1e-6)


# -- the grids ----------------------------------------------------------------

def _ridge_both(xs, ys, lambdas, **kwargs):
    got = engine.ridge_jackknife_sweep(xs, ys, lambdas, device='cpu',
                                       **kwargs)
    want = jax_engine.ridge_jackknife_sweep(xs, ys, lambdas, **kwargs)
    return got, want


@pytest.mark.parametrize('num_lambdas', [3, 25], ids=['cholesky', 'eig'])
def test_ridge_grid_matches_jax(num_lambdas):
    xs, ys = _stacked_corpus(8)
    lambdas = list(np.logspace(-4, 2, num_lambdas))
    got, want = _ridge_both(xs, ys, lambdas,
                            file_names=['f%d' % i for i in range(5)])
    assert got.correlations.shape == (num_lambdas, 5)
    assert got.test_files == want.test_files
    np.testing.assert_array_equal(got.lambdas, want.lambdas)
    np.testing.assert_allclose(got.correlations, want.correlations,
                               rtol=0, atol=R_TOL)
    assert got.correlations[0].min() > 0.8


def test_ridge_force_eig_program_matches_jax():
    xs, ys = _stacked_corpus(9)
    lambdas = np.asarray([1e-3, 0.1, 10.0], np.float32)
    stats = engine.per_file_stats(xs, ys, want_syy=True, device='cpu')
    total = covariance.MomentStats(*(s.sum(0) for s in stats))
    jstats = jax_engine.per_file_stats(xs, ys, want_syy=True)
    jtotal = jax_cov.MomentStats(*(a.sum(0) for a in jstats))
    got = engine._ridge_sweep_program(stats, total,
                                      torch.from_numpy(lambdas),
                                      force_eig=True)
    want = jax_engine._ridge_sweep_program(jstats, jtotal, lambdas,
                                           force_eig=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=R_TOL)


def test_shrinkage_grid_matches_jax():
    xs, ys = _stacked_corpus(10)
    got, want = _ridge_both(xs, ys, [0.0, 0.05, 0.5], use_ridge=False,
                            pad_files_to=6)
    np.testing.assert_allclose(got.correlations, want.correlations,
                               rtol=0, atol=R_TOL)


def test_context_ridge_grid_matches_jax_and_host():
    ctx = engine.ContextSpec(0, POST, 0, 0)
    xs_raw, ys_raw, xs_host, ys_host = _context_corpus(11, ctx, dy=1)
    lambdas = [1e-3, 1.0]
    got = engine.ridge_jackknife_sweep(xs_raw, ys_raw, lambdas,
                                       context=ctx, device='cpu')
    want = jax_engine.ridge_jackknife_sweep(
        xs_raw, ys_raw, lambdas, context=jax_engine.ContextSpec(*ctx))
    host = engine.ridge_jackknife_sweep(xs_host, ys_host, lambdas,
                                        device='cpu')
    np.testing.assert_allclose(got.correlations, want.correlations,
                               rtol=0, atol=R_TOL)
    np.testing.assert_allclose(got.correlations, host.correlations,
                               rtol=0, atol=R_TOL)


def test_shrinkage_rejects_the_auto_sentinel():
    xs, ys = _stacked_corpus(12)
    with pytest.raises(ValueError, match='-1 auto-shrinkage sentinel'):
        engine.ridge_jackknife_sweep(xs, ys, [0.1, -1], use_ridge=False,
                                     device='cpu')
    with pytest.raises(ValueError, match='-1 auto-shrinkage sentinel'):
        jax_engine.ridge_jackknife_sweep(xs, ys, [0.1, -1],
                                         use_ridge=False)


def test_cca_grid_matches_jax():
    xs, ys = _cca_corpus(13)
    lambdas = [1e-3, 0.1, 10.0]
    got = engine.cca_jackknife_sweep(xs, ys, lambdas, dims=2, device='cpu')
    want = jax_engine.cca_jackknife_sweep(xs, ys, lambdas, dims=2)
    np.testing.assert_allclose(got.correlations, want.correlations,
                               rtol=0, atol=R_TOL)
    assert got.correlations[0].min() > 0.5


def test_cca_eig_program_matches_jax_and_cholesky():
    xs, ys = _cca_corpus(14)
    lambdas = np.asarray([1e-3, 0.1, 10.0], np.float32)
    stats = engine.per_file_stats(xs, ys, want_syy=True, device='cpu')
    total = covariance.MomentStats(*(s.sum(0) for s in stats))
    jstats = jax_engine.per_file_stats(xs, ys, want_syy=True)
    jtotal = jax_cov.MomentStats(*(a.sum(0) for a in jstats))
    lam = torch.from_numpy(lambdas)
    eig = engine._cca_sweep_program(stats, total, lam).numpy()
    want = np.asarray(jax_engine._cca_sweep_program(jstats, jtotal,
                                                    lambdas))
    np.testing.assert_allclose(eig, want, rtol=0, atol=R_TOL)
    chol = engine._cca_sweep_program_chol(stats, total, lam).numpy()
    np.testing.assert_allclose(chol, eig, rtol=0, atol=R_TOL)


def _singular_files(seed, model):
    """A duplicated column makes every covariance exactly singular."""
    rng = np.random.RandomState(seed)
    w = rng.randn(4, 1).astype(np.float32)
    xs, ys = [], []
    for n in (300, 340, 280):
        base = rng.randn(n, 3).astype(np.float32)
        x = np.concatenate([base, base[:, :1]], axis=1)
        xs.append(x)
        if model == 'cca':
            ys.append((x[:, :2] + 0.1 * rng.randn(n, 2)).astype(np.float32))
        else:
            ys.append((x @ w + 0.05 * rng.randn(n, 1)).astype(np.float32))
    return xs, ys


@pytest.mark.parametrize('model', ['ridge', 'cca'])
def test_lambda0_singular_falls_back_to_eig_in_both(model):
    xs, ys = _singular_files(15, model)
    lambdas = [0.0, 1e-3]
    port_fn = (engine.cca_jackknife_sweep if model == 'cca' else
               engine.ridge_jackknife_sweep)
    jax_fn = (jax_engine.cca_jackknife_sweep if model == 'cca' else
              jax_engine.ridge_jackknife_sweep)
    # Both packages' Cholesky programs give NaN on the lambda = 0 row
    # (for at least one file: a pivot may round to a tiny positive) ...
    stats = engine.per_file_stats(xs, ys, want_syy=True, device='cpu')
    total = covariance.MomentStats(*(s.sum(0) for s in stats))
    jstats = jax_engine.per_file_stats(xs, ys, want_syy=True)
    jtotal = jax_cov.MomentStats(*(a.sum(0) for a in jstats))
    lam = np.asarray(lambdas, np.float32)
    if model == 'cca':
        chol = engine._cca_sweep_program_chol(stats, total,
                                              torch.from_numpy(lam))
        jchol = jax_engine._cca_sweep_program_chol(jstats, jtotal, lam)
    else:
        chol = engine._ridge_sweep_program(stats, total,
                                           torch.from_numpy(lam))
        jchol = jax_engine._ridge_sweep_program(jstats, jtotal, lam)
    assert not np.isfinite(chol.numpy()[0]).all()
    assert not np.isfinite(np.asarray(jchol)[0]).all()
    # ... and the sweeps rerun the eig program, finite and equal.
    got = port_fn(xs, ys, lambdas, device='cpu')
    want = jax_fn(xs, ys, lambdas)
    assert np.isfinite(got.correlations).all()
    np.testing.assert_allclose(got.correlations[0], want.correlations[0],
                               rtol=0, atol=SINGULAR_TOL)
    np.testing.assert_allclose(got.correlations[1:], want.correlations[1:],
                               rtol=0, atol=R_TOL)
    assert got.correlations.min() > 0.8


def test_dc_offset_matches_jax(rng):
    """Mirror of tests/test_sweep.py::test_moments_eval_tolerates_dc_offset
    (mu/sigma = 100 on x and y), on the same draws."""
    w = rng.randn(6, 1).astype(np.float32)
    xs, ys = [], []
    for _ in range(3):
        x = rng.randn(4000, 6).astype(np.float32)
        y = x @ w + 0.05 * rng.randn(4000, 1).astype(np.float32)
        xs.append(x + 100.0)
        ys.append(y + 100.0 * float(np.std(y)))
    got, want = _ridge_both(xs, ys, [1e-4, 1e-2])
    assert np.isfinite(got.correlations).all()
    assert np.all(got.correlations > 0.95), got.correlations
    np.testing.assert_allclose(got.correlations, want.correlations,
                               rtol=0, atol=DC_TOL)


def test_lam_chunk_units_matches_jax(monkeypatch):
    for env in [{}, {'TDT_SWEEP_LAM_CHUNK': '4.0'},
                {'TDT_SWEEP_LAM_CHUNK': '1e1'},
                {'TDT_SWEEP_LAM_CHUNK': 'banana'},
                {'TDT_SWEEP_LAM_CHUNK': 'inf'},
                {'TDT_SWEEP_LAM_CHUNK_BYTES': '1e9'},
                {'TDT_SWEEP_LAM_CHUNK_BYTES': 'inf'}]:
        monkeypatch.delenv('TDT_SWEEP_LAM_CHUNK', raising=False)
        monkeypatch.delenv('TDT_SWEEP_LAM_CHUNK_BYTES', raising=False)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        for args in [(10, 100, 9), (40, 2554 ** 2, 9),
                     (40, 2553 ** 2 + 31 ** 2, 9)]:
            assert engine._lam_chunk_units(*args) == \
                jax_engine._lam_chunk_units(*args), (env, args)
    monkeypatch.delenv('TDT_SWEEP_LAM_CHUNK_BYTES', raising=False)
    assert engine._lam_chunk_units(40, 2554 ** 2, 9) == 3


def test_chunked_grid_equals_one_chunk(monkeypatch):
    xs, ys = _stacked_corpus(17)
    lambdas = list(np.logspace(-3, 1, 5))
    monkeypatch.setenv('TDT_SWEEP_LAM_CHUNK', '2')
    chunked = engine.ridge_jackknife_sweep(xs, ys, lambdas, device='cpu')
    monkeypatch.setenv('TDT_SWEEP_LAM_CHUNK', '5')
    whole = engine.ridge_jackknife_sweep(xs, ys, lambdas, device='cpu')
    np.testing.assert_allclose(chunked.correlations, whole.correlations,
                               atol=1e-6)


def test_sweeps_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('checks the error on a machine without a card')
    xs, ys = _stacked_corpus(18)
    with pytest.raises(RuntimeError, match='No CUDA device'):
        engine.ridge_jackknife_sweep(xs, ys, [0.1])


# -- checkpoints ----------------------------------------------------------------

def test_checkpoint_tiles_roundtrip(tmp_path):
    ckpt = checkpoint.SweepCheckpoint(str(tmp_path), [0.1, 1.0],
                                      ['a', 'b', 'c'])
    assert not ckpt.has_tile('l0-2')
    tile = np.arange(6, dtype=np.float64).reshape(2, 3)
    ckpt.save_tile('l0-2', tile, slice(0, 2), slice(0, 3))
    assert ckpt.has_tile('l0-2')
    assert ckpt.completed_tiles == ['l0-2']
    np.testing.assert_array_equal(ckpt.load_tile('l0-2'), tile)
    np.testing.assert_array_equal(ckpt.assemble(), tile)


def test_checkpoint_resume_skips_completed_tiles(tmp_path):
    calls = []

    def sweep_fn(lambdas, file_slice):
        calls.append(tuple(lambdas))
        return np.full((len(lambdas), 3), sum(lambdas))

    lambdas = [0.1, 1.0, 10.0, 100.0]
    first = checkpoint.run_sweep_with_checkpoints(
        sweep_fn, lambdas, ['a', 'b', 'c'], str(tmp_path), lambda_block=2)
    again = checkpoint.run_sweep_with_checkpoints(
        sweep_fn, lambdas, ['a', 'b', 'c'], str(tmp_path), lambda_block=2)
    assert len(calls) == 2
    np.testing.assert_array_equal(first, again)
    np.testing.assert_allclose(first[2], 110.0)


def test_checkpoint_partial_failure_resumes_midway(tmp_path):
    state = {'calls': 0}

    def flaky(lambdas, file_slice):
        state['calls'] += 1
        if state['calls'] > 1:
            raise RuntimeError('preempted')
        return np.ones((len(lambdas), 2))

    with pytest.raises(RuntimeError):
        checkpoint.run_sweep_with_checkpoints(
            flaky, [1., 2., 3., 4.], ['a', 'b'], str(tmp_path),
            lambda_block=2)
    result = checkpoint.run_sweep_with_checkpoints(
        lambda l, s: 2 * np.ones((len(l), 2)), [1., 2., 3., 4.],
        ['a', 'b'], str(tmp_path), lambda_block=2)
    np.testing.assert_array_equal(result[:2], 1.0)
    np.testing.assert_array_equal(result[2:], 2.0)


def test_checkpoint_config_change_invalidates(tmp_path):
    checkpoint.run_sweep_with_checkpoints(
        lambda l, s: np.ones((len(l), 2)), [1., 2.], ['a', 'b'],
        str(tmp_path))
    result = checkpoint.run_sweep_with_checkpoints(
        lambda l, s: 3 * np.ones((len(l), 2)), [5., 6.], ['a', 'b'],
        str(tmp_path))
    np.testing.assert_array_equal(result, 3.0)
    assert checkpoint._config_key([1., 2.], ['a'], {'model': 'cca'}) == \
        jax_checkpoint._config_key([1., 2.], ['a'], {'model': 'cca'})


def _two_writers(module, directory):
    """Two checkpoints open on one directory, each saves a tile; returns
    the tiles a third one sees."""
    lambdas, files = [0.1, 1.0], ['a', 'b']
    first = module.SweepCheckpoint(directory, lambdas, files)
    second = module.SweepCheckpoint(directory, lambdas, files)
    first.save_tile('l0-1', np.ones((1, 2)), slice(0, 1), slice(0, 2))
    second.save_tile('l1-2', np.zeros((1, 2)), slice(1, 2), slice(0, 2))
    return sorted(module.SweepCheckpoint(directory, lambdas,
                                         files).completed_tiles)


def test_checkpoint_keeps_both_writers_tiles(tmp_path):
    """The port merges the manifest on disk before each save."""
    assert _two_writers(checkpoint, str(tmp_path)) == ['l0-1', 'l1-2']


def test_jax_checkpoint_loses_the_first_writers_tile(tmp_path):
    """The JAX package's manifest is last-writer-wins (ADVICE.md on
    sweep/checkpoint.py:61): the first writer's tile drops out."""
    assert _two_writers(jax_checkpoint, str(tmp_path)) == ['l1-2']


def test_jax_written_checkpoint_resumes_in_the_port(tmp_path):
    lambdas, files = [0.1, 1.0, 10.0], ['a', 'b']
    extra = {'model': 'linear', 'dims': 5}

    def jax_block(block, file_slice):
        if block[0] == 10.0:
            raise RuntimeError('preempted')
        return np.full((len(block), 2), block[0])

    with pytest.raises(RuntimeError):
        jax_checkpoint.run_sweep_with_checkpoints(
            jax_block, lambdas, files, str(tmp_path), lambda_block=1,
            extra_config=extra)
    with open(os.path.join(str(tmp_path), 'manifest.json')) as f:
        assert sorted(json.load(f)['tiles']) == ['l0-1', 'l1-2']
    calls = []

    def port_block(block, file_slice):
        calls.append(list(block))
        return np.full((len(block), 2), -1.0)

    result = checkpoint.run_sweep_with_checkpoints(
        port_block, lambdas, files, str(tmp_path), lambda_block=1,
        extra_config=extra)
    assert calls == [[10.0]]
    np.testing.assert_array_equal(result, [[0.1, 0.1], [1.0, 1.0],
                                           [-1.0, -1.0]])
    # And back: the port's tile loads in the JAX package.
    again = jax_checkpoint.run_sweep_with_checkpoints(
        jax_block, lambdas, files, str(tmp_path), lambda_block=1,
        extra_config=extra)
    np.testing.assert_array_equal(again, result)
