"""The deep CCA of the PyTorch port vs the JAX package: cca_loss and
apply_cca, the model (towers, final CCA, dense and streamed fits), its
model directories, and its decoder, which folds the final CCA into
kernel K1 on the towers' outputs (on the CPU, K1's plain version).

Parity is held through carried parameters (models.convert), as in
test_torch_sgd_models.py. The inputs of the gradient tests share a
planted latent whose canonical correlations are well apart (scales 2, 1,
0.5 against noise 0.5): eigh's backward divides by differences of
eigenvalues in both frameworks and is unstable where two are equal.

Tolerances: forward passes 1e-5; cca_loss 1e-5 relative, its gradients
1e-4 of the largest; the streamed fit 1e-4 on losses and tower
parameters (the same numpy batch stream); the final CCA's canonical
correlations 1e-4 and its outputs 1e-4 of the largest output up to
each dimension's sign, which the SVD picks freely; decoder scores rtol
1e-4 / atol 1e-4 (the fused decode's float32 bound,
tests/test_decode_kernel.py). The dense fit draws from torch
generators, so it is held to the JAX package's own bar on the same
data: the first canonical correlation of a planted latent above 0.4
(tpu_checks.py:235-269).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from telluride_decoding_tpu.cli import serve as jax_serve
from telluride_decoding_tpu.data import brain_data as jax_bd
from telluride_decoding_tpu.decode import infer_decoder as jax_infer
from telluride_decoding_tpu.models import BrainModelDCCA as JaxDCCA
from telluride_decoding_tpu.models import BrainModelDNN as JaxDNN
from telluride_decoding_tpu.models import load_model as jax_load_model
from telluride_decoding_tpu.solvers import cca as jax_cca
from telluride_decoding_torch.cli import serve
from telluride_decoding_torch.data import brain_data, records
from telluride_decoding_torch.decode import infer_decoder
from telluride_decoding_torch.models import convert
from telluride_decoding_torch.models.brain_model import load_model
from telluride_decoding_torch.models.cca import BrainModelDCCA
from telluride_decoding_torch.solvers import cca

from test_torch_infer_decoder import CHANNELS, recordings, stacked

FORWARD_TOL = 1e-5
GRAD_TOL = 1e-4
TRAJECTORY_TOL = 1e-4
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)
DIMS, HIDDEN = 3, [8]
WIDTH1, WIDTH2 = CHANNELS * 5, 5
FLAGS = {'pre_context': 0, 'post_context': 4, 'input2_pre_context': 2,
         'input2_post_context': 2, 'dnn_regressor': 'dcca'}


def planted(n=400, seed=0):
    """input_1 [n, 40] and input_2 [n, 5] sharing a 3-dim latent at
    scales 2, 1 and 0.5 under noise 0.5 (canonical correlations near
    0.9, 0.7 and 0.3, well apart)."""
    rng = np.random.RandomState(seed)
    latent = rng.randn(n, 3) * np.array([2.0, 1.0, 0.5])
    x1 = np.concatenate([latent @ rng.randn(3, 10) +
                         0.5 * rng.randn(n, 10), rng.randn(n, 30)], 1)
    x2 = np.concatenate([latent + 0.5 * rng.randn(n, 3),
                         rng.randn(n, 2)], 1)
    return x1.astype(np.float32), x2.astype(np.float32)


def model_pair(seed=3, lr=1e-2, dims=DIMS, width1=WIDTH1):
    """{'jax': DCCA, 'torch': DCCA} holding the JAX initialisation."""
    jax_model = JaxDCCA(cca_dims=dims, hidden_units=HIDDEN,
                        regularization_lambda=1e-2, input1_width=width1,
                        input2_width=WIDTH2)
    jax_model.compile(learning_rate=lr)
    jax_model.params = jax_model._init_params(jax.random.PRNGKey(seed))
    torch_model = convert.sgd_params_from_numpy(
        'BrainModelDCCA', jax.tree_util.tree_map(np.asarray,
                                                 jax_model.params),
        'cpu', jax_model.config())
    torch_model.compile(learning_rate=lr)
    return {'jax': jax_model, 'torch': torch_model}


def as_inputs(x1, x2):
    return {'input_1': x1, 'input_2': x2}


def assert_close_up_to_sign(got, want, tol):
    """[N, 2D] canonical outputs, each dimension d (and d + D) up to the
    sign the SVD chose, within ``tol`` of the largest output."""
    half = want.shape[1] // 2
    scale = np.abs(want).max()
    for d in range(half):
        sign = np.sign(np.sum(got[:, d] * want[:, d]))
        for col in (d, d + half):
            np.testing.assert_allclose(sign * got[:, col], want[:, col],
                                       rtol=0, atol=tol * scale)


# -- the solver functions -----------------------------------------------------

def test_cca_loss_and_apply_cca_match_jax():
    x1, x2 = planted()
    x1 = x1[:, :4]
    want = jax_cca.cca_loss(x1, x2[:, :3], 2, rcov1=1e-2, rcov2=1e-3)
    got = cca.cca_loss(torch.from_numpy(x1), torch.from_numpy(x2[:, :3]),
                       2, rcov1=1e-2, rcov2=1e-3)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    solution = cca.calculate_cca_parameters(torch.from_numpy(x1),
                                            torch.from_numpy(x2), dim=2)
    jax_solution = jax_cca.CcaSolution(*(jnp.asarray(t.numpy())
                                         for t in solution))
    np.testing.assert_allclose(
        cca.apply_cca(solution, torch.from_numpy(x1),
                      torch.from_numpy(x2)).numpy(),
        np.asarray(jax_cca.apply_cca(jax_solution, x1, x2)), rtol=0,
        atol=FORWARD_TOL)


def test_cca_loss_gradient_matches_jax():
    x1, x2 = planted()
    x1, x2 = x1[:, :5], x2[:, :4]
    want = jax.grad(lambda a, b: jax_cca.cca_loss(a, b, 3, 1e-3, 1e-3),
                    argnums=(0, 1))(x1, x2)
    a, b = (torch.from_numpy(x).requires_grad_(True) for x in (x1, x2))
    cca.cca_loss(a, b, 3, 1e-3, 1e-3).backward()
    for got, w in zip((a.grad, b.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max())


# -- the model ----------------------------------------------------------------

def test_forward_matches_jax():
    pair = model_pair()
    x1, x2 = planted()
    np.testing.assert_allclose(
        pair['torch'](as_inputs(x1, x2)).numpy(),
        np.asarray(pair['jax'].apply(pair['jax'].params,
                                     as_inputs(x1, x2))),
        rtol=0, atol=FORWARD_TOL)


def test_loss_and_gradients_match_jax():
    """-cca_loss of the two towers on one batch."""
    pair = model_pair()
    x1, x2 = planted(n=256)
    want_loss, want = jax.value_and_grad(pair['jax']._loss_fn)(
        pair['jax'].params, as_inputs(x1, x2), None)
    params = {k: v.clone().requires_grad_(True)
              for k, v in pair['torch'].params.items()}
    got_loss = pair['torch']._loss_fn(
        params, as_inputs(torch.from_numpy(x1), torch.from_numpy(x2)), None)
    got_loss.backward()
    assert float(got_loss.detach()) == pytest.approx(float(want_loss),
                                                     rel=1e-5)
    want = convert.flat_params(jax.tree_util.tree_map(np.asarray, want))
    scale = max(np.abs(g).max() for g in want.values())
    for key, w in want.items():
        grad = params[key].grad
        got = np.zeros_like(w) if grad is None else grad.numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=key)


@pytest.fixture(scope='module')
def train():
    return recordings(files=3, frames=700)[0]


@pytest.fixture(scope='module')
def data_pair(tmp_path_factory):
    """(port, JAX) TFExampleData over three files of planted(): eeg
    (input_1, 40 columns) and intensity (input_2, 5), no context."""
    path = str(tmp_path_factory.mktemp('dcca_data'))
    for i in range(3):
        x1, x2 = planted(n=700 + 37 * i, seed=10 + i)
        records.convert_data_to_tfrecords(
            {'eeg': x1, 'intensity': x2},
            os.path.join(path, 'trial%d.tfrecords' % i))
    args = dict(in_fields='eeg', out_field='intensity', frame_rate=100,
                in2_fields='intensity', data_dir=path,
                train_file_pattern='trial')
    return (brain_data.TFExampleData(device='cpu', **args),
            jax_bd.TFExampleData(**args))


def test_streaming_fit_follows_the_jax_trajectory(data_pair):
    """One epoch of batches of 100 over three files from the same
    parameters: losses and towers; then the final CCA from the streamed
    moments of the towers' outputs.

    cca_loss centres each view, so a tower's last bias has no gradient
    in exact arithmetic and Adam walks it by rounding, in each package
    its own way; it is held as b - mean, which the model computes with.
    The recordings of test_torch_infer_decoder.py are no data for this
    test: there the port against itself, inputs moved by one ulp,
    parts by 5e-4 in the loss within the epoch."""
    pair = model_pair()
    port_data, jax_data = data_pair
    kwargs = dict(epochs=1, batch_size=100, seed=3)
    want = pair['jax'].fit_streaming(jax_data, 'train', **kwargs)
    got = pair['torch'].fit_streaming(port_data, 'train', **kwargs)
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=0,
                               atol=TRAJECTORY_TOL)
    flat = convert.flat_params(jax.tree_util.tree_map(np.asarray,
                                                      pair['jax'].params))
    ours = {k: v.numpy() for k, v in pair['torch'].params.items()}
    last = len(HIDDEN)
    for values in (flat, ours):
        for tower in (1, 2):
            values['tower%d/%d/b' % (tower, last)] = (
                values['tower%d/%d/b' % (tower, last)] -
                values['mean%d' % tower][0])
    for key, value in flat.items():
        if key.startswith('tower'):
            np.testing.assert_allclose(ours[key], value, rtol=0,
                                       atol=TRAJECTORY_TOL, err_msg=key)
    np.testing.assert_allclose(pair['torch'].eigenvalues,
                               pair['jax'].eigenvalues, rtol=0,
                               atol=TRAJECTORY_TOL)
    x1, x2 = planted()
    assert_close_up_to_sign(
        pair['torch'](as_inputs(x1, x2)).numpy(),
        np.asarray(pair['jax'].apply(pair['jax'].params, as_inputs(x1, x2))),
        TRAJECTORY_TOL)


def test_dense_final_cca_matches_jax(train):
    """A dense fit of no epochs: the closed-form CCA of the same towers'
    outputs over the training arrays."""
    pair = model_pair()
    batches = stacked(train, 1)
    pair['jax'].fit(batches, epochs=0, batch_size=256)
    pair['torch'].fit(batches, epochs=0, batch_size=256)
    np.testing.assert_allclose(pair['torch'].eigenvalues,
                               pair['jax'].eigenvalues, rtol=0,
                               atol=TRAJECTORY_TOL)
    inputs, _ = batches[0]
    assert_close_up_to_sign(
        pair['torch'](inputs).numpy(),
        np.asarray(pair['jax'].apply(pair['jax'].params, inputs)),
        TRAJECTORY_TOL)


def test_dcca_learns_the_planted_latent():
    """tpu_checks.py:235-269 in both packages: two views sharing a 2-dim
    latent; the first canonical correlation of the trained towers is
    above 0.4."""
    rng = np.random.RandomState(0)
    n = 4000
    latent = rng.randn(n, 2).astype(np.float32)
    v1 = np.concatenate([latent + 0.3 * rng.randn(n, 2),
                         rng.randn(n, 6)], axis=1).astype(np.float32)
    v2 = np.concatenate([latent @ rng.randn(2, 2).astype(np.float32)
                         + 0.3 * rng.randn(n, 2),
                         rng.randn(n, 1)], axis=1).astype(np.float32)
    corr = {}
    for name, module, cls, extra in (
            ('jax', jax_bd, JaxDCCA, {}),
            ('torch', brain_data, BrainModelDCCA, {'device': 'cpu'})):
        data = module.TestBrainData('input_1', 'ones', 100.0,
                                    in2_fields='input_2',
                                    final_batch_size=1000,
                                    shuffle_buffer_size=0, **extra)
        data.preserve_test_data(v1, np.ones((n, 1), np.float32),
                                input2_data=v2)
        model = cls(cca_dims=2, hidden_units=[16],
                    regularization_lambda=1e-2, input1_width=8,
                    input2_width=3, **extra)
        model.compile(learning_rate=1e-3)
        model.fit(data.create_dataset('train'), epochs=40, batch_size=1000)
        corr[name] = model.evaluate(data.create_dataset('train'))[
            'cca_pearson_correlation_first']
    assert min(corr.values()) > 0.4, corr


@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_model_dirs_load_across_packages(writer, tmp_path):
    pair = model_pair()
    pair[writer].save(str(tmp_path))
    x1, x2 = planted()
    want = np.asarray(pair['jax'].apply(pair['jax'].params,
                                        as_inputs(x1, x2)))
    if writer == 'jax':
        got = load_model(str(tmp_path), 'cpu')(as_inputs(x1, x2)).numpy()
    else:
        loaded = jax_load_model(str(tmp_path))
        got = np.asarray(loaded.apply(loaded.params, as_inputs(x1, x2)))
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_TOL)


# -- the decoder --------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_dcca_dir(tmp_path_factory, train):
    """A DCCA trained, LDA-trained and saved by the JAX package."""
    path = str(tmp_path_factory.mktemp('jax_dcca'))
    model = JaxDCCA(cca_dims=DIMS, hidden_units=HIDDEN,
                    regularization_lambda=1e-2, input1_width=WIDTH1,
                    input2_width=WIDTH2)
    model.compile(learning_rate=1e-2)
    model.fit(stacked(train, 1), epochs=3, batch_size=256)
    decoder = jax_infer.CCADecoder(model, reduction='lda')
    decoder.train(stacked(train, 2), stacked(train, 1), window_size=100)
    model.add_metadata(FLAGS)
    model.save(path)
    decoder.save_parameters(os.path.join(path, 'decoder_model.json'))
    return path


def frames(train):
    inputs, y = stacked(train, 1)[0]
    other, _ = stacked(train, 2)[0]
    return (inputs['input_1'][:500], inputs['input_2'][:500],
            other['input_2'][:500], y[:500])


@pytest.mark.parametrize('reduction', ['lda', 'first', 'mean-squared'])
def test_decoder_scores_match_jax(jax_dcca_dir, train, reduction):
    """The same model and LDA: infer_one and infer_pair (K1 on the
    towers' outputs with the LDA reduction; plain torch otherwise)."""
    x1, x2a, x2b, y = frames(train)
    want = jax_infer.create_decoder(jax_dcca_dir, reduction=reduction)
    want.load_decoding_model(jax_dcca_dir)
    want.restore_parameters(os.path.join(jax_dcca_dir,
                                         'decoder_model.json'))
    got = serve.load_model(jax_dcca_dir, reduction, 'cpu')
    assert isinstance(got, infer_decoder.CCADecoder)
    np.testing.assert_allclose(
        got.infer_one(as_inputs(x1, x2a), y),
        want.infer_one(as_inputs(x1, x2a), y), **SCORE_TOL)
    for g, w in zip(got.infer_pair(x1, x2a, x2b, y, y),
                    want.infer_pair(x1, x2a, x2b, y, y)):
        np.testing.assert_allclose(g, w, **SCORE_TOL)


def test_fold_rotates_the_tower_outputs(jax_dcca_dir, train, monkeypatch):
    """K1 gets h1 = tower1(input_1) and h2 = tower2(input_2), never the
    raw inputs, with the final CCA's rot1 and rot2 [cca_dims, cca_dims]."""
    seen = []
    kernel = infer_decoder.fused_cca_decode

    def spy(folded, x1, x2, x2b=None):
        seen.append((folded, x1, x2, x2b))
        return kernel(folded, x1, x2, x2b)
    monkeypatch.setattr(infer_decoder, 'fused_cca_decode', spy)
    decoder = serve.load_model(jax_dcca_dir, 'lda', 'cpu')
    x1, x2a, x2b, y = frames(train)
    decoder.infer_pair(x1, x2a, x2b, y, y)
    (folded, k1, k2a, k2b), = seen
    model = decoder.decoding_model
    assert tuple(folded.rot1.shape) == (DIMS, DIMS)
    torch.testing.assert_close(k1[:, 0], model.tower(1, x1))
    torch.testing.assert_close(k2a[:, 0], model.tower(2, x2a))
    torch.testing.assert_close(k2b[:, 0], model.tower(2, x2b))


def test_fold_never_rotates_input_1_with_the_dcca_rotation(train):
    """A DCCA whose input_1 is as wide as its canonical space, so that
    rot1 would also fit the raw input: the decoder's scores are the JAX
    decoder's (towers, then the final CCA), not those of rot1 applied to
    input_1."""
    pair = model_pair(dims=3, width1=3)
    rng = np.random.RandomState(8)
    flat = convert.flat_params(jax.tree_util.tree_map(np.asarray,
                                                      pair['jax'].params))
    flat['rot1'] = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    flat['rot2'] = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    pair['jax']._restore_params(flat)
    pair['torch']._restore_params(flat)
    x1 = rng.randn(300, 3).astype(np.float32)
    x2 = rng.randn(300, 5).astype(np.float32)
    x2b = rng.randn(300, 5).astype(np.float32)
    decoders = {'jax': jax_infer.CCADecoder(pair['jax'], reduction='lda'),
                'torch': infer_decoder.CCADecoder(pair['torch'],
                                                  reduction='lda',
                                                  device='cpu')}
    for decoder in decoders.values():
        decoder.train([(as_inputs(x1, x2b), x2b)], [(as_inputs(x1, x2), x2)],
                      window_size=10)
    want = decoders['jax'].infer_one(as_inputs(x1, x2), x2)
    got = decoders['torch'].infer_one(as_inputs(x1, x2), x2)
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    folded = decoders['torch']._pipeline.folded
    on_raw = infer_decoder.fused_cca_decode(
        folded, torch.from_numpy(x1)[:, None], torch.from_numpy(
            pair['torch'].tower(2, x2).numpy())[:, None]).numpy()
    assert np.abs(on_raw - want).max() > 100 * SCORE_TOL['atol']


def test_port_trained_decoder_scores_in_jax(train, tmp_path):
    """A DCCA trained and LDA-trained by the port loads in the JAX
    package and scores the same."""
    model = BrainModelDCCA(cca_dims=DIMS, hidden_units=HIDDEN,
                           regularization_lambda=1e-2, input1_width=WIDTH1,
                           input2_width=WIDTH2, device='cpu')
    model.compile(learning_rate=1e-2)
    model.fit(stacked(train, 1), epochs=3, batch_size=256)
    decoder = infer_decoder.CCADecoder(model, reduction='lda', device='cpu')
    assert decoder.train(stacked(train, 2), stacked(train, 1),
                         window_size=100) > 1.0
    model.add_metadata(FLAGS)
    model.save(str(tmp_path))
    decoder.save_parameters(str(tmp_path / 'decoder_model.json'))
    x1, x2a, x2b, y = frames(train)
    want = jax_infer.create_decoder(str(tmp_path), reduction='lda')
    want.load_decoding_model(str(tmp_path))
    want.restore_parameters(str(tmp_path / 'decoder_model.json'))
    for g, w in zip(decoder.infer_pair(x1, x2a, x2b, y, y),
                    want.infer_pair(x1, x2a, x2b, y, y)):
        np.testing.assert_allclose(g, w, **SCORE_TOL)


def test_refit_rebuilds_the_folded_pipeline(train):
    """The fold caches on the model's params_version: a refit (Adam
    updates in place) must serve the new towers."""
    model = BrainModelDCCA(cca_dims=DIMS, hidden_units=HIDDEN,
                           regularization_lambda=1e-2, device='cpu',
                           input1_width=WIDTH1, input2_width=WIDTH2)
    model.compile(learning_rate=1e-2)
    model.fit(stacked(train, 1), epochs=1, batch_size=256)
    decoder = infer_decoder.CCADecoder(model, reduction='lda', device='cpu')
    decoder.train(stacked(train, 2), stacked(train, 1), window_size=100)
    x1, x2a, _, y = frames(train)
    before = decoder.infer_one(as_inputs(x1, x2a), y)
    model.fit(stacked(train, 1), epochs=1, batch_size=256)
    after = decoder.infer_one(as_inputs(x1, x2a), y)
    fresh = infer_decoder.CCADecoder(model, reduction='lda', device='cpu')
    fresh.model_params = decoder.model_params
    np.testing.assert_array_equal(after, fresh.infer_one(as_inputs(x1, x2a),
                                                         y))
    assert not np.array_equal(before, after)


# -- serving ------------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_dnn_dir(tmp_path_factory, train):
    """A DNN regressor of the attended intensity, trained and
    LDA-trained (LinearRegressionDecoder) by the JAX package."""
    path = str(tmp_path_factory.mktemp('jax_dnn'))
    model = JaxDNN(num_hidden_list=[8], input_width=WIDTH1, output_width=1)
    model.compile(learning_rate=1e-2)
    model.fit(stacked(train, 1), epochs=3, batch_size=256)
    decoder = jax_infer.LinearRegressionDecoder(model, reduction='lda')
    decoder.train(stacked(train, 2), stacked(train, 1), window_size=100)
    model.add_metadata(dict(FLAGS, dnn_regressor='fullyconnected'))
    model.save(path)
    decoder.save_parameters(os.path.join(path, 'decoder_model.json'))
    return path


@pytest.mark.parametrize('kind', ['dcca', 'dnn'])
def test_serve_stream_matches_jax(request, kind):
    """tdt-serve of a JAX-written DCCA or DNN directory: the same
    decisions, window scores within 1e-4."""
    path = request.getfixturevalue('jax_%s_dir' % kind)
    _, (eeg, a1, a2) = recordings(files=1, frames=100, stream_frames=1500)
    kwargs = dict(chunk_size=32, reduction='lda', window_width=100,
                  window_step=50)
    got = serve.serve_stream(path, eeg, a1, a2, device='cpu', **kwargs)
    want = jax_serve.serve_stream(path, eeg, a1, a2, **kwargs)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g['attend_speaker1'] == w['attend_speaker1']
        for key in ('score1', 'score2'):
            assert g[key] == pytest.approx(w[key], abs=SCORE_TOL['atol'])


def test_create_decoder_by_class_and_tag(jax_dcca_dir, jax_dnn_dir):
    for tag, cls in ((jax_dcca_dir, infer_decoder.CCADecoder),
                     (jax_dnn_dir, infer_decoder.LinearRegressionDecoder),
                     ('dcca', infer_decoder.CCADecoder),
                     ('fullyconnected',
                      infer_decoder.LinearRegressionDecoder)):
        assert type(infer_decoder.create_decoder(tag, device='cpu')) is cls
    with pytest.raises(ValueError, match='determine model type'):
        infer_decoder.create_decoder('classifier', device='cpu')
