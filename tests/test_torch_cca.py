"""CCA solver of the PyTorch port vs the JAX package.

Both sides solve the same float32 problem with different LAPACK backends
(XLA's and torch's eigh/SVD), so:
  * covariances: within 1e-5 of each matrix's largest magnitude (sums in
    another order);
  * canonical correlations (eigenvalues): rtol 1e-4;
  * rotations: equal up to a per-column sign, within 1e-3 of the
    column's largest magnitude (eigenvectors of float32 eigh agree to
    about 1e-5 relative at these well-separated spectra; 1e-3 leaves
    room for the whitening product);
  * decoded products r1 * r2: without any sign alignment (the u and v
    columns of the SVD flip together), within 1e-3 of their scale.
"""

import numpy as np
import pytest
import torch

from telluride_decoding_tpu.data import brain_data as jax_bd
from telluride_decoding_tpu.models import BrainModelCCA as JaxCCA
from telluride_decoding_tpu.ops import covariance as jax_covariance
from telluride_decoding_tpu.solvers import cca as jax_cca
from telluride_decoding_torch.data import brain_data, records
from telluride_decoding_torch.models.cca import BrainModelCCA
from telluride_decoding_torch.ops import covariance
from telluride_decoding_torch.solvers import cca


def _views(rng, n=2000):
    latent = rng.randn(n, 3)
    x = np.concatenate([latent * [3.0, 2.0, 1.0] + 0.3 * rng.randn(n, 3),
                        rng.randn(n, 9)], axis=1).astype(np.float32) + 0.2
    y = np.concatenate([latent + 0.5 * rng.randn(n, 3),
                        rng.randn(n, 2)], axis=1).astype(np.float32)
    return x, y


def _stats(x, y):
    return (covariance.moments_from_arrays(torch.from_numpy(x),
                                           torch.from_numpy(y),
                                           want_syy=True),
            jax_covariance.moments_from_arrays(x, y, want_syy=True))


def test_covariances_match_jax(rng):
    got, want = _stats(*_views(rng))
    for g, w in zip(cca.cca_covariances_from_stats(got),
                    jax_cca.cca_covariances_from_stats(want)):
        w = np.asarray(w)
        assert np.max(np.abs(g.numpy() - w)) <= 1e-5 * np.max(np.abs(w))


@pytest.mark.parametrize('regularization', [1e-3, 0.1])
def test_solution_matches_jax(rng, regularization):
    x, y = _views(rng)
    got_stats, want_stats = _stats(x, y)
    got = cca.solve_cca_from_moments(got_stats, dim=3,
                                     regularization=regularization)
    want = jax_cca.solve_cca_from_moments(want_stats, dim=3,
                                          regularization=regularization)
    np.testing.assert_allclose(got.eigenvalues.numpy(),
                               np.asarray(want.eigenvalues), rtol=1e-4)
    np.testing.assert_allclose(got.mean_x.numpy(), np.asarray(want.mean_x),
                               rtol=1e-5, atol=1e-6)
    for g, w in ((got.rot_x, want.rot_x), (got.rot_y, want.rot_y)):
        g = g.numpy()
        w = np.asarray(w)
        signs = np.sign(np.sum(g * w, axis=0))
        scale = np.max(np.abs(w), axis=0)
        assert np.all(np.abs(g * signs - w) <= 1e-3 * scale)
    # Decoded products need no sign alignment.
    prod_got = (x @ got.rot_x.numpy()) * (y @ got.rot_y.numpy())
    prod_want = (x @ np.asarray(want.rot_x)) * (y @ np.asarray(want.rot_y))
    assert np.max(np.abs(prod_got - prod_want)) <= 1e-3 * np.max(
        np.abs(prod_want))


def test_calculate_cca_parameters_blocked_matches_jax(rng):
    x, y = _views(rng, n=3000)
    got = cca.calculate_cca_parameters(torch.from_numpy(x),
                                       torch.from_numpy(y), dim=2,
                                       regularization=0.01, block=1024)
    want = jax_cca.calculate_cca_parameters(x, y, dim=2, regularization=0.01,
                                            block=1024)
    np.testing.assert_allclose(got.eigenvalues.numpy(),
                               np.asarray(want.eigenvalues), rtol=1e-4)


def test_fit_streaming_from_tfrecords_matches_jax(rng, tmp_path):
    """BrainModelCCA.fit_streaming(brain_data, mode) in both packages
    over the same TFRecord files: the same canonical correlations and,
    up to a per-column sign, the same rotations."""
    for i in range(3):
        x, y = _views(rng, n=700 + 50 * i)
        records.convert_data_to_tfrecords(
            {'eeg': x, 'intensity': y[:, :1]},
            str(tmp_path / ('trial_%d.tfrecords' % i)))
    args = dict(in_fields='eeg', out_field='intensity', frame_rate=100,
                pre_context=0, post_context=2, in2_fields='intensity',
                in2_pre_context=1, in2_post_context=1,
                data_dir=str(tmp_path), train_file_pattern='trial')
    got = BrainModelCCA(cca_dims=2, regularization_lambda=1e-3, device='cpu')
    got.fit_streaming(brain_data.TFExampleData(device='cpu', **args),
                      'train')
    want = JaxCCA(cca_dims=2, regularization_lambda=1e-3, input1_width=36,
                  input2_width=3)
    want.fit_streaming(jax_bd.TFExampleData(**args), 'train')
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-4)
    assert got.config()['input1_width'] == 36
    for g, w in ((got.rot1, want.rot_x), (got.rot2, want.rot_y)):
        g = g.numpy()
        signs = np.sign(np.sum(g * w, axis=0))
        assert np.all(np.abs(g * signs - w) <=
                      1e-3 * np.max(np.abs(w), axis=0))
