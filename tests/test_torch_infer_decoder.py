"""Decoder of the PyTorch port vs the JAX package, across model dirs.

A model directory written by either package (model.json, weights.npz,
decoder_model.json) loads in the other and scores the same frames the
same. Tolerance: rtol 1e-4 / atol 1e-4 on the scores, the float32 bound
of the fused decode (tests/test_decode_kernel.py), since the port folds
the LDA into the decode and sums in another order.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

from telluride_decoding_tpu.decode import infer_decoder as jax_infer  # noqa: E402
from telluride_decoding_tpu.models import BrainModelCCA as JaxCCA  # noqa: E402
from telluride_decoding_tpu.ops.lagstack import lag_stack_np  # noqa: E402
from telluride_decoding_torch.cli import serve  # noqa: E402
from telluride_decoding_torch.decode import infer_decoder  # noqa: E402
from telluride_decoding_torch.models import brain_model, convert  # noqa: E402
from telluride_decoding_torch.models.cca import BrainModelCCA  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
CHANNELS, DIMS = 8, 3
CONTEXTS = (0, 4, 2, 2)      # pre, post (EEG); pre, post (audio).
FLAGS = {'pre_context': 0, 'post_context': 4, 'input2_pre_context': 2,
         'input2_post_context': 2, 'dnn_regressor': 'cca'}


def recordings(files=2, frames=2000, stream_frames=2000):
    return chip_smoke.synthetic_recordings(3, CHANNELS, files, frames,
                                           stream_frames)


def stacked(train, speaker):
    """(input_dict, output) minibatches, one per file, of the attended
    (speaker 1) or unattended (speaker 2) pairing."""
    pre, post, pre2, post2 = CONTEXTS
    return [({'input_1': lag_stack_np(rec[0], pre, post),
              'input_2': lag_stack_np(rec[speaker], pre2, post2)},
             rec[speaker]) for rec in train]


def jax_model_dir(path, train):
    """Fit, train and save with the JAX package; returns its d'."""
    model = JaxCCA(cca_dims=DIMS, regularization_lambda=1e-3,
                   input1_width=CHANNELS * 5, input2_width=5)
    model.fit(stacked(train, 1))
    decoder = jax_infer.CCADecoder(model, reduction='lda')
    dprime = decoder.train(stacked(train, 2), stacked(train, 1),
                           window_size=100)
    model.add_metadata(FLAGS)
    model.save(path)
    decoder.save_parameters(os.path.join(path, 'decoder_model.json'))
    return dprime


def port_brain_data(path, train, in2='intensity'):
    """The port's TFExampleData over the recordings, written once as
    TFRecords beside ``path``; ``in2`` picks the speaker paired with the
    EEG (intensity: speaker 1, intensity2: speaker 2)."""
    data_dir = path.rstrip(os.sep) + '_records'
    if not os.path.isdir(data_dir):
        chip_smoke.write_records(train, data_dir)
    return chip_smoke.brain_data(data_dir, 'cpu', in2, 100, CONTEXTS,
                                 train_file_pattern='trial')


def port_model_dir(path, train):
    """Fit (file-wise, from the TFRecords), train and save with the
    port; returns its d'."""
    model = BrainModelCCA(cca_dims=DIMS, regularization_lambda=1e-3,
                          device='cpu')
    model.fit_streaming(port_brain_data(path, train), 'train')
    decoder = infer_decoder.CCADecoder(model, reduction='lda', device='cpu')
    dprime = decoder.train(stacked(train, 2), stacked(train, 1),
                           window_size=100)
    model.add_metadata(FLAGS)
    model.save(path)
    decoder.save_parameters(os.path.join(path, 'decoder_model.json'))
    return dprime


def _frames(train):
    inputs, _ = stacked(train, 1)[0]
    other, _ = stacked(train, 2)[0]
    return inputs['input_1'][:500], inputs['input_2'][:500], \
        other['input_2'][:500], train[0][1][:500]


def _jax_decoder(path, reduction='lda'):
    from telluride_decoding_tpu.cli.infer import load_model
    return load_model(path, reduction)


@pytest.mark.parametrize('reduction', ['lda', 'first', 'mean'])
def test_jax_model_dir_scores_same_in_port(tmp_path, reduction):
    train, _ = recordings()
    jax_model_dir(str(tmp_path), train)
    x1, x2a, x2b, y = _frames(train)
    want = _jax_decoder(str(tmp_path), reduction)
    got = serve.load_model(str(tmp_path), reduction, 'cpu')
    np.testing.assert_allclose(
        got.infer_one({'input_1': x1, 'input_2': x2a}, y),
        want.infer_one({'input_1': x1, 'input_2': x2a}, y), **TOL)
    for g, w in zip(got.infer_pair(x1, x2a, x2b, y, y),
                    want.infer_pair(x1, x2a, x2b, y, y)):
        np.testing.assert_allclose(g, w, **TOL)


def test_port_model_dir_scores_same_in_jax(tmp_path):
    train, _ = recordings()
    port_model_dir(str(tmp_path), train)
    x1, x2a, x2b, y = _frames(train)
    want = serve.load_model(str(tmp_path), 'lda', 'cpu')
    got = _jax_decoder(str(tmp_path))
    for g, w in zip(got.infer_pair(x1, x2a, x2b, y, y),
                    want.infer_pair(x1, x2a, x2b, y, y)):
        np.testing.assert_allclose(g, w, **TOL)


def test_port_training_matches_jax_on_same_model(tmp_path):
    """Given the same CCA weights, the port's decoder training lands on
    the JAX package's statistics, LDA and d'."""
    train, _ = recordings()
    dprime = jax_model_dir(str(tmp_path), train)
    model = brain_model.load_model(str(tmp_path), 'cpu')
    decoder = infer_decoder.CCADecoder(model, reduction='lda', device='cpu')
    assert decoder.train(stacked(train, 2), stacked(train, 1),
                         window_size=100) == pytest.approx(dprime, rel=1e-3)
    got = decoder.correlation_params
    want = _jax_decoder(str(tmp_path)).correlation_params
    assert got.count == want.count
    # Positive statistics compare relatively; the sums and means of the
    # (near zero-mean) rotated streams cancel, so they compare absolutely
    # at the float32 rounding of a sum of `count` O(1) terms.
    for name, tol in (('sum_x2', dict(rtol=1e-4)), ('sum_y2', dict(rtol=1e-4)),
                      ('power', dict(rtol=1e-4)), ('sum_x', dict(atol=1e-3)),
                      ('sum_y', dict(atol=1e-3)), ('mean_x', dict(atol=1e-6)),
                      ('mean_y', dict(atol=1e-6))):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   **tol)


def test_refit_invalidates_cached_pipeline(tmp_path):
    train, _ = recordings()
    port_model_dir(str(tmp_path), train)
    decoder = serve.load_model(str(tmp_path), 'lda', 'cpu')
    x1, x2a, _, y = _frames(train)
    before = decoder.infer_one({'input_1': x1, 'input_2': x2a}, y)
    model = decoder.decoding_model
    model.fit_streaming(port_brain_data(str(tmp_path), train, 'intensity2'))
    after = decoder.infer_one({'input_1': x1, 'input_2': x2a}, y)
    fresh = infer_decoder.CCADecoder(model, reduction='lda', device='cpu')
    fresh.model_params = decoder.model_params
    np.testing.assert_array_equal(
        after, fresh.infer_one({'input_1': x1, 'input_2': x2a}, y))
    assert not np.allclose(before, after)


def test_model_evaluate_matches_jax(tmp_path):
    """The CCA model's metric (first canonical correlation) and its
    rotated outputs agree across packages on the same weights."""
    train, _ = recordings()
    jax_model_dir(str(tmp_path), train)
    data = stacked(train, 1)
    want_model = JaxCCA(cca_dims=DIMS, regularization_lambda=1e-3,
                        input1_width=CHANNELS * 5, input2_width=5)
    want_model.fit(data)
    got_model = brain_model.load_model(str(tmp_path), 'cpu')
    want = want_model.evaluate(data)
    got = got_model.evaluate(data)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-4)
    np.testing.assert_allclose(got_model.predict(data),
                               want_model.predict(data), rtol=1e-4,
                               atol=1e-4)


def test_weights_convert_from_flat_numpy(rng):
    flat = {'mean1': rng.randn(1, 6), 'mean2': rng.randn(1, 4),
            'rot1': rng.randn(6, 2), 'rot2': rng.randn(4, 2)}
    model = convert.cca_params_from_numpy(flat, 'cpu')
    assert model.config()['input1_width'] == 6
    x1, x2 = rng.randn(5, 6), rng.randn(5, 4)
    out = model({'input_1': x1, 'input_2': x2}).numpy()
    want = np.concatenate([(x1 - flat['mean1']) @ flat['rot1'],
                           (x2 - flat['mean2']) @ flat['rot2']], axis=1)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        convert.cca_params_from_numpy(dict(flat, mean1=np.zeros((1, 5))),
                                      'cpu')


def test_create_decoder_refuses_unported_models(tmp_path):
    meta = tmp_path / 'model.json'
    meta.write_text('{"model_class": "BrainModelLinearRegression"}')
    with pytest.raises(ValueError):
        infer_decoder.create_decoder(str(tmp_path), device='cpu')
    with pytest.raises(ValueError):
        infer_decoder.create_decoder('my_linear_model', device='cpu')
    assert isinstance(infer_decoder.create_decoder('my_cca', device='cpu'),
                      infer_decoder.CCADecoder)


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError):
        infer_decoder.CCADecoder(None, reduction='lda', device='cuda')
