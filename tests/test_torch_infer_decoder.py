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
    """Linear-regression dirs and tags now get the linear decoder; a
    reference SavedModel directory with no readable checkpoint and a
    name that names no family (as in the JAX package) and an unknown tag
    still raise."""
    meta = tmp_path / 'model.json'
    meta.write_text('{"model_class": "BrainModelLinearRegression"}')
    assert isinstance(infer_decoder.create_decoder(str(tmp_path),
                                                   device='cpu'),
                      infer_decoder.LinearRegressionDecoder)
    assert isinstance(infer_decoder.create_decoder('my_linear_model',
                                                   device='cpu'),
                      infer_decoder.LinearRegressionDecoder)
    saved = tmp_path / 'reference_dir'
    saved.mkdir()
    (saved / 'saved_model.pb').write_bytes(b'')
    with pytest.raises(ValueError):
        infer_decoder.create_decoder(str(saved), device='cpu')
    with pytest.raises(ValueError):
        infer_decoder.create_decoder('my_model', device='cpu')
    assert isinstance(infer_decoder.create_decoder('my_cca', device='cpu'),
                      infer_decoder.CCADecoder)


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError):
        infer_decoder.CCADecoder(None, reduction='lda', device='cuda')


# -- the decoder's evaluation helpers ------------------------------------

EVAL_TOL = dict(rtol=1e-5, atol=1e-5)
EVAL_ARGS = dict(in_fields='eeg', out_field='intensity', frame_rate=100,
                 pre_context=0, post_context=4, in2_fields='intensity',
                 in2_pre_context=2, in2_post_context=2,
                 train_file_pattern='allbut',
                 validate_file_pattern='trial_02',
                 test_file_pattern='trial_02', final_batch_size=128,
                 shuffle_buffer_size=0)


def _sources(data_dir, **kwargs):
    """Fresh TFExampleData of both packages over the same files, so
    both generators start from the same state."""
    from telluride_decoding_tpu.data import brain_data as jax_bd
    from telluride_decoding_torch.data import brain_data
    args = dict(EVAL_ARGS, data_dir=data_dir, **kwargs)
    return (brain_data.TFExampleData(device='cpu', **args),
            jax_bd.TFExampleData(**args))


def _evaluation_decoders(tmp_path, kind):
    """A model and decoder trained by the JAX package on TFRecords and
    saved; returns (port decoder, JAX decoder) loaded from that dir and
    the records directory."""
    from telluride_decoding_tpu.models import BrainModelLinearRegression
    train, _ = recordings(files=3, frames=1200)
    data_dir = str(tmp_path / 'records')
    chip_smoke.write_records(train, data_dir)
    _, ref = _sources(data_dir)
    spec = ref.spec_dataset()
    if kind == 'linear':
        model = BrainModelLinearRegression(spec, 1e-3)
        decoder = jax_infer.LinearRegressionDecoder(model, reduction='lda')
    else:
        model = JaxCCA(spec, cca_dims=DIMS, regularization_lambda=1e-3)
        decoder = jax_infer.CCADecoder(model, reduction='lda')
    model.fit(ref.create_dataset('train'))
    decoder.train(ref.create_dataset('test', mixup_batch=True),
                  ref.create_dataset('test'), window_size=50)
    model.add_metadata(dict(FLAGS, dnn_regressor=kind), dataset=spec)
    path = str(tmp_path / 'model')
    model.save(path)
    decoder.save_parameters(os.path.join(path, 'decoder_model.json'))
    return (serve.load_model(path, 'lda', 'cpu'), _jax_decoder(path),
            data_dir)


def _assert_pairs_close(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for g_part, w_part in zip(g, w):
            np.testing.assert_allclose(g_part, w_part, **EVAL_TOL)


@pytest.mark.parametrize('kind', ['linear', 'cca'])
def test_evaluation_helpers_match_jax(tmp_path, kind):
    """test_all, test_by_window (window_size 50 and 1), frame_scores on
    both paths, window_means, test_by_window_means, reduce_with_lda and
    check_model_and_data on the same model dir and files, within 1e-5."""
    got, want, data_dir = _evaluation_decoders(tmp_path, kind)
    assert isinstance(got, infer_decoder.LinearRegressionDecoder if
                      kind == 'linear' else infer_decoder.CCADecoder)
    assert got.model_inputs == want.model_inputs
    assert got.model_output == want.model_output
    port, ref = _sources(data_dir)
    _assert_pairs_close([got.test_all(port.create_dataset('test'))],
                        [want.test_all(ref.create_dataset('test'))])
    for window in (50, 1):
        _assert_pairs_close(
            got.test_by_window(port.create_dataset('test'), window),
            want.test_by_window(ref.create_dataset('test'), window))
    fast = got.frame_scores(port.create_dataset('test'))
    slow = got.frame_scores(list(port.create_dataset('test')))
    assert fast[0].shape == (1152,)      # 1200 frames cut to 9 x 128.
    _assert_pairs_close([fast, slow],
                        [want.frame_scores(ref.create_dataset('test'))] * 2)
    # Mixup makes the slow path decode the transformed batches; both
    # sources draw the same permutations from fresh generators.
    port, ref = _sources(data_dir)
    _assert_pairs_close(
        [got.frame_scores(port.create_dataset('test', mixup_batch=True))],
        [want.frame_scores(ref.create_dataset('test', mixup_batch=True))])
    _assert_pairs_close(
        [got.window_means(*fast, 50)],
        [jax_infer.Decoder.window_means(*fast, 50)])
    _assert_pairs_close(
        [got.test_by_window_means(port.create_dataset('test'), 50)],
        [want.test_by_window_means(ref.create_dataset('test'), 50)])
    correlations = np.random.RandomState(2).randn(
        20, 1 if kind == 'linear' else DIMS)
    np.testing.assert_allclose(got.reduce_with_lda(correlations),
                               want.reduce_with_lda(correlations),
                               **EVAL_TOL)
    got.check_model_and_data(port.create_dataset('test'))
    want.check_model_and_data(ref.create_dataset('test'))
    port, ref = _sources(data_dir, post_context=2)
    with pytest.raises(TypeError):
        got.check_model_and_data(port.create_dataset('test'))
    with pytest.raises(TypeError):
        want.check_model_and_data(ref.create_dataset('test'))


def test_window_helpers_edge_cases():
    scores = np.arange(10, dtype=np.float64)
    labels = np.ones(10)
    means, mean_labels = infer_decoder.Decoder.window_means(scores, labels,
                                                            4)
    np.testing.assert_allclose(means, [1.5, 3.5, 5.5, 7.5])
    np.testing.assert_allclose(mean_labels, 1.0)
    # window_size 1 steps by one frame, not zero.
    assert infer_decoder.Decoder.window_means(scores, labels,
                                              1)[0].shape == (10,)
    assert infer_decoder.Decoder.window_means(scores, labels,
                                              11)[0].shape == (0,)
    decoder = infer_decoder.LinearRegressionDecoder(None, device='cpu')
    with pytest.raises(ValueError):
        decoder.reduce_with_lda(np.zeros((3, 1)))
    with pytest.raises(ValueError):
        decoder.check_model_and_data([])
    assert decoder.frame_scores([])[0].shape == (0,)


def test_module_create_dataset_matches_jax(tmp_path):
    """The two-speaker test dataset of one file: the audio label as
    input_2 and output, in stored order, batches of 200."""
    from telluride_decoding_torch.data import records
    (eeg, a1, a2), = recordings(files=1, frames=900)[0]
    path = str(tmp_path / 'two_speakers.tfrecords')
    records.convert_data_to_tfrecords(
        {'eeg': eeg, 'intensity': a1, 'intensity2': a2,
         'attended_speaker': (np.arange(900) >= 450).astype(
             np.float32)[:, None]}, path)
    params = {'input_field': 'eeg', 'pre_context': 0, 'post_context': 4,
              'input2_pre_context': 2, 'input2_post_context': 2}
    for label in ('intensity', 'intensity2'):
        got = list(infer_decoder.create_dataset(path, params, label,
                                                device='cpu'))
        want = list(jax_infer.create_dataset(path, params, label))
        assert len(got) == len(want) == 4
        for (g_in, g_out), (w_in, w_out) in zip(got, want):
            for key in w_in:
                np.testing.assert_array_equal(g_in[key], w_in[key])
            np.testing.assert_array_equal(g_out, w_out)
