"""Models of the PyTorch port vs the JAX package: the linear regression
(dense fit, streamed fit, evaluation under both protocols and both
losses) and the CCA model fit from a BrainDataset.

The same TFRecord files feed both packages. Predictions, metrics and
weights agree within 1e-4 (float32 moments summed in another order and
a solve of a well-conditioned 26-column system; weights relative to the
largest). Model directories written by either package load in the other
and predict the same.
"""

import numpy as np
import pytest
import torch

from telluride_decoding_tpu.data import brain_data as jax_bd
from telluride_decoding_tpu.models import BrainModelCCA as JaxCCA
from telluride_decoding_tpu.models import (
    BrainModelLinearRegression as JaxLinear)
from telluride_decoding_tpu.models import load_model as jax_load_model
from telluride_decoding_torch.data import brain_data, records
from telluride_decoding_torch.models import brain_model
from telluride_decoding_torch.models.brain_model import (
    BrainModelLinearRegression)
from telluride_decoding_torch.models.cca import BrainModelCCA

TOL = 1e-4


@pytest.fixture
def data_dir(tmp_path):
    """Four files of EEG that follows the intensity through a TRF."""
    rng = np.random.RandomState(5)
    trf = rng.randn(5, 4)
    for i in range(4):
        n = 400 + 23 * i
        intensity = np.abs(rng.randn(n, 1)).astype(np.float32)
        eeg = np.stack([np.convolve(intensity[:, 0], trf[c])[:n]
                        for c in range(5)], axis=1)
        eeg = (eeg + 0.5 * rng.randn(n, 5)).astype(np.float32)
        records.convert_data_to_tfrecords(
            {'eeg': eeg, 'intensity': intensity,
             'intensity2': np.abs(rng.randn(n, 1)).astype(np.float32)},
            str(tmp_path / ('trial%d.tfrecords' % i)))
    return str(tmp_path)


def _pair(data_dir, **kwargs):
    args = dict(in_fields='eeg', out_field='intensity', frame_rate=100,
                pre_context=0, post_context=4, in2_fields='intensity2',
                in2_pre_context=1, in2_post_context=1, data_dir=data_dir,
                train_file_pattern='allbut', validate_file_pattern='trial1',
                test_file_pattern='trial1', final_batch_size=128,
                shuffle_buffer_size=100)
    args.update(kwargs)
    return (brain_data.TFExampleData(device='cpu', **args),
            jax_bd.TFExampleData(**args))


def _close(got, want, scale=None):
    want = np.asarray(want)
    scale = np.max(np.abs(want)) if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(scale, 1.0))


def _linear_pair(port_data, ref_data, streaming=False, lamb=0.01):
    got = BrainModelLinearRegression(port_data.spec_dataset(), lamb,
                                     device='cpu')
    want = JaxLinear(ref_data.spec_dataset(), lamb)
    if streaming:
        got.fit_streaming(port_data, 'train')
        want.fit_streaming(ref_data, 'train')
    else:
        got.fit(port_data.create_dataset('train'))
        want.fit(ref_data.create_dataset('train'))
    return got, want


@pytest.mark.parametrize('streaming', [False, True],
                         ids=['dense', 'streamed'])
def test_linear_fit_matches_jax(data_dir, streaming):
    port_data, ref_data = _pair(data_dir)
    got, want = _linear_pair(port_data, ref_data, streaming)
    assert got.config() == want.config()
    for g, w in zip(got.weight_matrices, want.weight_matrices):
        assert g.shape == w.shape
        _close(g, w)
    test_in = port_data.create_dataset('test')
    _close(got.predict(test_in), want.predict(ref_data.create_dataset('test')))


@pytest.mark.parametrize('protocol', ['whole_split', 'reference'])
@pytest.mark.parametrize('loss', ['mse', 'pearson'])
def test_linear_evaluate_matches_jax(data_dir, protocol, loss):
    port_data, ref_data = _pair(data_dir,
                                reference_protocol=protocol == 'reference')
    got, want = _linear_pair(port_data, ref_data)
    got.compile(learning_rate=0.05, loss=loss)
    want.compile(learning_rate=0.05, loss=loss)
    got_metrics = got.evaluate(port_data.create_dataset('test'))
    want_metrics = want.evaluate(ref_data.create_dataset('test'))
    assert list(got_metrics) == list(want_metrics)
    for key in want_metrics:
        assert got_metrics[key] == pytest.approx(want_metrics[key],
                                                 rel=TOL, abs=TOL)


@pytest.mark.parametrize('name', [
    'mse', 'pearson_correlation_first', 'pearson_correlation_second',
    'pearson_correlation', 'cca_pearson_correlation_first',
    'cca_pearson_correlation_second', 'accuracy', 'binary_crossentropy'])
def test_metrics_match_jax(rng, name):
    # Four columns: the cca metrics split them into two halves of two.
    y_true = (rng.rand(300, 4) > 0.5).astype(np.float32)
    y_pred = np.clip(0.6 * y_true + 0.4 * rng.rand(300, 4), 0.01,
                     0.99).astype(np.float32)
    port = BrainModelLinearRegression(device='cpu')
    got = port._metric(name, torch.from_numpy(y_true),
                       torch.from_numpy(y_pred))
    want = JaxLinear()._metric(name, y_true, y_pred)
    assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-6)


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_linear_model_dirs_load_across_packages(data_dir, tmp_path, writer):
    port_data, ref_data = _pair(data_dir)
    got, want = _linear_pair(port_data, ref_data)
    for model, data in ((got, port_data), (want, ref_data)):
        model.add_metadata({'post_context': 4},
                           dataset=data.spec_dataset())
    path = str(tmp_path / 'model')
    if writer == 'port':
        got.save(path)
        loaded, source = jax_load_model(path), got
    else:
        want.save(path)
        loaded, source = brain_model.load_model(path, 'cpu'), want
    assert type(loaded).__name__ == 'BrainModelLinearRegression'
    assert loaded.config() == source.config()
    assert loaded.telluride_inputs == source.telluride_inputs == (
        '{"input_1": [null, 25], "input_2": [null, 3], '
        '"attended_speaker": [null, 1]}')
    x = port_data.create_dataset('test').all_arrays()[0]
    _close(np.asarray(loaded({'input_1': x, 'input_2': x[:, :1]})),
           np.asarray(source({'input_1': x, 'input_2': x[:, :1]})))


def test_cca_fit_from_brain_dataset_matches_jax(data_dir):
    port_data, ref_data = _pair(data_dir)
    got = BrainModelCCA(port_data.spec_dataset(), cca_dims=2,
                        regularization_lambda=1e-3, device='cpu')
    want = JaxCCA(ref_data.spec_dataset(), cca_dims=2,
                  regularization_lambda=1e-3)
    assert got.config() == want.config()
    got.fit(port_data.create_dataset('train'))
    want.fit(ref_data.create_dataset('train'))
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-4,
                               atol=1e-5)
    # Rotations compare up to each column's sign (eigh and SVD choose
    # it freely); the canonical outputs follow their rotations.
    test_in = port_data.create_dataset('test').all_arrays()
    out_got = got({'input_1': test_in[0], 'input_2': test_in[1]}).numpy()
    out_want = np.asarray(want({'input_1': test_in[0],
                                'input_2': test_in[1]}))
    signs = np.sign(np.sum(out_got * out_want, axis=0))
    _close(out_got * signs, out_want)


def test_summary_names_weights(data_dir, capsys):
    port_data, ref_data = _pair(data_dir)
    got, want = _linear_pair(port_data, ref_data)
    text = got.summary()
    assert text == want.summary() == '\n'.join([
        'Model: BrainModelLinearRegression', '  b: (1,)', '  w: (25, 1)',
        'Total params: 26'])
    assert text in capsys.readouterr().out


def test_linear_weights_convert_from_jax_numpy(data_dir):
    """The JAX model's weights as a flat numpy dict become the port's
    model, which computes what the JAX model computes."""
    from telluride_decoding_torch.models import convert
    port_data, ref_data = _pair(data_dir)
    want = JaxLinear(ref_data.spec_dataset(), 0.01)
    want.fit(ref_data.create_dataset('train'))
    flat = {'w': np.asarray(want.params['w']),
            'b': np.asarray(want.params['b'])}
    got = convert.linear_params_from_numpy(flat, 'cpu')
    assert got.config() == {'regularization_lambda': 0.0,
                            'input_width': 25, 'output_width': 1}
    x = port_data.create_dataset('test').all_arrays()[0]
    _close(got({'input_1': x}).numpy(),
           np.asarray(want({'input_1': x, 'input_2': x[:, :1]})))
    with pytest.raises(ValueError):
        convert.linear_params_from_numpy(dict(flat, b=np.zeros(3)), 'cpu')
