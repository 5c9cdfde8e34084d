"""The SGD families of the PyTorch port vs the JAX package: the DNN
regressor (with and without batch norm), the match-mismatch classifier,
their training and their model directories, and the experiment driver
for all three SGD families (the deep CCA's own tests are in
test_torch_dcca.py).

JAX draws its initialisation, dense-fit permutations and dropout from
threefry keys, which torch cannot reproduce. So parity is held through
carried parameters: a JAX model's params go into the port's model with
models.convert, and the same numpy inputs go through both.

Tolerances, each with its reason:
  * forward passes, 1e-5 absolute: float32 products of 40-wide inputs
    summed in another order;
  * loss 1e-5 relative, gradients 1e-4 of the largest gradient
    (autograd against jax.grad, float32);
  * Adam steps, 1e-6, or 2.5e-5 of the learning rate where that is
    more: optax computes its bias corrections 1 - 0.999^t in float32,
    where 0.999 is off by 1.3e-8 and 1 - 0.999^t magnifies that up to a
    thousandfold (1.2e-5 of the step at t = 1), torch in float64;
  * the streamed fit, 1e-4 on losses and parameters: its batches are the
    JAX fit's (numpy-seeded file order and permutations; checked array
    for array), so this is a trajectory test of some 20 Adam steps.
    With batch norm the bias of a normalised layer has no gradient in
    exact arithmetic (the batch mean takes it out), so Adam turns
    float32 rounding into steps of the learning rate, in each package
    its own; the normalised values are the same in exact arithmetic but
    not in their rounding, and a ReLU input within rounding of zero
    switches its gradient. Replayed step by step on the test's stream
    the two agree within 2.3e-6 for 14 steps and then part (1e-3 at
    step 20). So the batch-norm fit is held step by step: each step
    from the JAX step's parameters on the same batch;
  * batch-norm population statistics, rtol 1e-5 / atol 1e-5: sums of
    squares over 2000 frames in another order;
  * model directories, 1e-5 on predictions;
  * the dense fit draws from torch generators, so it is held to the JAX
    suite's own quality bars in both packages on the same data: DNN r
    above 0.97 on the TRF simulation (tests/test_decoding.py:188), the
    classifier above 0.65 with mismatch batches (tests/test_decoding.py:
    242) and above 0.9 on the reference's classifier corpus
    (tools/ab_reference.py:539-610).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from telluride_decoding_tpu.cli import decoding as jax_decoding
from telluride_decoding_tpu.data import brain_data as jax_bd
from telluride_decoding_tpu.models import (
    BrainModelClassifier as JaxClassifier)
from telluride_decoding_tpu.models import BrainModelDNN as JaxDNN
from telluride_decoding_tpu.models import load_model as jax_load_model
from telluride_decoding_torch.cli import decoding
from telluride_decoding_torch.data import brain_data, records
from telluride_decoding_torch.models import convert
from telluride_decoding_torch.models.brain_model import (
    BrainModelClassifier, BrainModelDNN, load_model)
from tools import ab_reference

import test_torch_decoding

FORWARD_TOL = 1e-5
GRAD_TOL = 1e-4
ADAM_TOL = 1e-6
TRAJECTORY_TOL = 1e-4
POPULATION_TOL = dict(rtol=1e-5, atol=1e-5)
WIDTH, WIDTH2, HIDDEN = 40, 3, [8, 8]
STREAM = dict(epochs=1, batch_size=100, seed=3)
# (JAX class, constructor config) of each family at test width.
FAMILIES = {
    'dnn': (JaxDNN, dict(num_hidden_list=HIDDEN, input_width=WIDTH,
                         output_width=1)),
    'dnn_bn': (JaxDNN, dict(num_hidden_list=HIDDEN, input_width=WIDTH,
                            output_width=1, batch_norm=True)),
    'classifier': (JaxClassifier, dict(num_hidden_list=HIDDEN,
                                       input_width=WIDTH,
                                       input2_width=WIDTH2,
                                       output_width=1)),
}


@pytest.fixture(scope='module')
def data_dir(tmp_path_factory):
    """Three files of 4 EEG channels that follow the intensity through a
    TRF: 10 lags give 40 columns; intensity2 with one lag either side
    gives input_2's 3; label is 0 or 1 (the classifier's output)."""
    d = tmp_path_factory.mktemp('sgd_records')
    rng = np.random.RandomState(5)
    trf = rng.randn(4, 5)
    for i in range(3):
        n = 700 + 37 * i
        intensity = np.abs(rng.randn(n, 1)).astype(np.float32)
        eeg = np.stack([np.convolve(intensity[:, 0], trf[c])[:n]
                        for c in range(4)], axis=1)
        intensity2 = np.abs(rng.randn(n, 1)).astype(np.float32)
        records.convert_data_to_tfrecords(
            {'eeg': (eeg + 0.5 * rng.randn(n, 4)).astype(np.float32),
             'intensity': intensity, 'intensity2': intensity2,
             'label': (intensity2 > 0.8).astype(np.float32)},
            str(d / ('trial%d.tfrecords' % i)))
    return str(d)


def data_pair(data_dir, output='intensity'):
    """(port, JAX) TFExampleData over every file."""
    args = dict(in_fields='eeg', out_field=output, frame_rate=100,
                pre_context=0, post_context=9, in2_fields='intensity2',
                in2_pre_context=1, in2_post_context=1, data_dir=data_dir,
                train_file_pattern='', validate_file_pattern='',
                test_file_pattern='', final_batch_size=128,
                shuffle_buffer_size=0)
    return (brain_data.TFExampleData(device='cpu', **args),
            jax_bd.TFExampleData(**args))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def model_pair(family, seed=1, lr=1e-2, loss='mse'):
    """{'jax': model, 'torch': model} holding the same parameters (the
    JAX model's initialisation; random population statistics with batch
    norm)."""
    cls, config = FAMILIES[family]
    jax_model = cls(**config)
    jax_model.compile(learning_rate=lr, loss=loss)
    params = jax_model._init_params(jax.random.PRNGKey(seed))
    if family == 'dnn_bn':
        rng = np.random.RandomState(seed)
        params['bn'] = [
            dict(entry, mean=jnp.asarray(rng.randn(8), jnp.float32),
                 var=jnp.asarray(0.5 + rng.rand(8), jnp.float32))
            for entry in params['bn']]
    jax_model.params = params
    torch_model = convert.sgd_params_from_numpy(
        type(jax_model).__name__, numpy_tree(params), 'cpu',
        jax_model.config())
    torch_model.compile(learning_rate=lr, loss=loss)
    return {'jax': jax_model, 'torch': torch_model}


def inputs(n=256, seed=0):
    rng = np.random.RandomState(seed)
    return {'input_1': rng.randn(n, WIDTH).astype(np.float32),
            'input_2': rng.randn(n, WIDTH2).astype(np.float32)}


def flat_jax(jax_model):
    return convert.flat_params(numpy_tree(jax_model.params))


def assert_params_close(torch_model, jax_model, tol, normalised=()):
    """Every parameter within ``tol``; the biases of the layers in
    ``normalised`` (batch norm follows them) as b - population mean."""
    want = flat_jax(jax_model)
    got = {k: v.numpy() for k, v in torch_model.params.items()}
    assert sorted(got) == sorted(want)
    for i in normalised:
        for values in (got, want):
            values['layers/%d/b' % i] = (values['layers/%d/b' % i] -
                                         values['bn/%d/mean' % i])
            del values['bn/%d/mean' % i]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol,
                                   err_msg=key)


# -- the forward pass, the loss and its gradients, one Adam step --------------

@pytest.mark.parametrize('family,training', [
    ('dnn', False), ('dnn_bn', False), ('dnn_bn', True),
    ('classifier', False)])
def test_forward_matches_jax(family, training):
    pair = model_pair(family)
    x = inputs()
    if training:
        want = pair['jax']._forward(pair['jax'].params, x['input_1'],
                                    training=True)
        got = pair['torch']._forward(pair['torch'].params,
                                     torch.from_numpy(x['input_1']),
                                     training=True)
    else:
        want = pair['jax'].apply(pair['jax'].params, x)
        got = pair['torch'](x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FORWARD_TOL)


@pytest.mark.parametrize('family,loss', [
    ('dnn', 'mse'), ('dnn', 'pearson'), ('dnn_bn', 'mse'),
    ('classifier', 'mse')])
def test_loss_and_gradients_match_jax(family, loss):
    """mse and the Pearson loss of the DNN (its loss follows compile),
    the classifier's binary cross-entropy, on one batch."""
    pair = model_pair(family, loss=loss)
    x = inputs(n=128, seed=1)
    rng = np.random.RandomState(2)
    y = (rng.rand(128, 1) > 0.5 if family == 'classifier'
         else rng.randn(128, 1)).astype(np.float32)
    want_loss, want_grads = jax.value_and_grad(pair['jax']._loss_fn)(
        pair['jax'].params, x, y)
    params = {k: v.clone().requires_grad_(True)
              for k, v in pair['torch'].params.items()}
    got_loss = pair['torch']._loss_fn(
        params, {k: torch.from_numpy(v) for k, v in x.items()},
        torch.from_numpy(y))
    got_loss.backward()
    assert float(got_loss.detach()) == pytest.approx(float(want_loss),
                                                     rel=1e-5)
    want_grads = convert.flat_params(numpy_tree(want_grads))
    scale = max(np.abs(g).max() for g in want_grads.values())
    for key, want in want_grads.items():
        grad = params[key].grad
        got = np.zeros_like(want) if grad is None else grad.numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=key)


@pytest.mark.parametrize('lr', [1e-3, 0.05])
def test_adam_steps_match_optax(lr):
    """Three steps of the port's optimizer against optax.adam from the
    same parameters and gradients (bias corrections of steps 1-3), at
    compile's default rate and the driver's."""
    model = model_pair('dnn', lr=lr)['torch']
    rng = np.random.RandomState(4)
    start = {k: v.numpy().copy() for k, v in model.params.items()}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in start.items()} for _ in range(3)]
    params = {k: torch.from_numpy(v.copy()).requires_grad_(True)
              for k, v in start.items()}
    opt = model._optimizer(params)
    jax_params = {k: jnp.asarray(v) for k, v in start.items()}
    jax_opt = optax.adam(lr)
    state = jax_opt.init(jax_params)
    for step in grads:
        for key, value in params.items():
            value.grad = torch.from_numpy(step[key])
        opt.step()
        updates, state = jax_opt.update(
            {k: jnp.asarray(v) for k, v in step.items()}, state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for key in start:
            np.testing.assert_allclose(params[key].detach().numpy(),
                                       np.asarray(jax_params[key]), rtol=0,
                                       atol=max(ADAM_TOL, 2.5e-5 * lr),
                                       err_msg=key)


# -- the streamed fit and the population statistics ---------------------------

def recorded_streams(pair, port_data, jax_data):
    """Runs both streamed fits (one epoch, batches of 100) and returns
    the batches and per-step losses each package trained on:
    {'jax': [(x1, x2, y, loss)], 'torch': [...]}, with each JAX step
    started from the port's parameters before it (for a step by step
    comparison) when ``pair['replay']`` is set."""
    seen = {'jax': [], 'torch': []}
    jax_model, port_model = pair['jax'], pair['torch']
    make_step = jax_model._streaming_step

    def jax_step(opt, lr):
        step = make_step(opt, lr)

        def recorded(params, opt_state, x1, x2, y, key):
            out = step(params, opt_state, x1, x2, y, key)
            seen['jax'].append((np.asarray(x1), np.asarray(x2),
                                np.asarray(y), float(out[2])))
            return out
        return recorded
    port_step = port_model._step

    def recorded_port(params, opt, x1, x2, y, gen):
        loss = port_step(params, opt, x1, x2, y, gen)
        seen['torch'].append((x1.numpy(), x2.numpy(), y.numpy(),
                              float(loss)))
        return loss
    jax_model._streaming_step = jax_step
    port_model._step = recorded_port
    results = (jax_model.fit_streaming(jax_data, 'train', **STREAM),
               port_model.fit_streaming(port_data, 'train', **STREAM))
    return seen, results


@pytest.mark.parametrize('family', ['classifier', 'dnn'])
def test_streaming_fit_follows_the_jax_trajectory(data_dir, family):
    """One epoch of batches of 100 over the three files (some 20 Adam
    steps, leftovers carried across files) from the same parameters:
    the same batches, losses and parameters."""
    pair = model_pair(family)
    port_data, jax_data = data_pair(
        data_dir, 'label' if family == 'classifier' else 'intensity')
    seen, (want, got) = recorded_streams(pair, port_data, jax_data)
    assert len(seen['torch']) == len(seen['jax']) >= 20
    for ours, theirs in zip(seen['torch'], seen['jax']):
        for a, b in zip(ours[:3], theirs[:3]):
            assert np.array_equal(a, b)
        assert ours[3] == pytest.approx(theirs[3], abs=TRAJECTORY_TOL)
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=0,
                               atol=TRAJECTORY_TOL)
    assert_params_close(pair['torch'], pair['jax'], TRAJECTORY_TOL)
    x = inputs()
    np.testing.assert_allclose(
        pair['torch'](x).numpy(),
        np.asarray(pair['jax'].apply(pair['jax'].params, x)), rtol=0,
        atol=TRAJECTORY_TOL)


def test_batch_norm_streaming_fit_steps_match_jax(data_dir):
    """The batch-norm DNN's streamed fit: the same batches as the JAX
    fit, and every step, taken from the same parameters on the same
    batch, the same loss and parameters (see the module docstring for
    why not the whole trajectory)."""
    pair = model_pair('dnn_bn')
    port_data, jax_data = data_pair(data_dir)
    seen, _ = recorded_streams(pair, port_data, jax_data)
    assert len(seen['torch']) == len(seen['jax']) >= 20
    for ours, theirs in zip(seen['torch'], seen['jax']):
        for a, b in zip(ours[:3], theirs[:3]):
            assert np.array_equal(a, b)
    steps = model_pair('dnn_bn')
    jax_opt = optax.adam(1e-2)
    jax_step = steps['jax']._streaming_step(jax_opt, 1e-2)
    jax_params = steps['jax'].params
    jax_state = jax_opt.init(jax_params)
    port = steps['torch']
    for x1, x2, y, _ in seen['jax']:
        params = {k: torch.from_numpy(v.copy()).requires_grad_(True)
                  for k, v in convert.flat_params(
                      numpy_tree(jax_params)).items()}
        opt = port._optimizer(params)
        # The JAX state's moments and count, in torch's form.
        mu, nu, count = (convert.flat_params(numpy_tree(jax_state[0].mu)),
                         convert.flat_params(numpy_tree(jax_state[0].nu)),
                         int(jax_state[0].count))
        for key, value in params.items():
            if count:
                opt.state[value] = {
                    'step': torch.tensor(float(count)),
                    'exp_avg': torch.from_numpy(mu[key].copy()),
                    'exp_avg_sq': torch.from_numpy(nu[key].copy())}
        got = port._step(params, opt, *(torch.from_numpy(a)
                                        for a in (x1, x2, y)), None)
        jax_params, jax_state, want = jax_step(jax_params, jax_state, x1,
                                               x2, y, jax.random.PRNGKey(0))
        assert float(got) == pytest.approx(float(want), abs=TRAJECTORY_TOL)
        flat = convert.flat_params(numpy_tree(jax_params))
        for key, value in params.items():
            # Not trained (population statistics), or normalised away
            # (the biases under batch norm, whose steps are rounding).
            if key.endswith(('mean', 'var')) or key in ('layers/0/b',
                                                        'layers/1/b'):
                continue
            np.testing.assert_allclose(value.detach().numpy(), flat[key],
                                       rtol=0, atol=2.5e-5 * 1e-2 + 1e-6,
                                       err_msg=key)


def test_streaming_fit_of_a_corpus_smaller_than_a_batch(data_dir):
    """One short batch, as in the JAX package."""
    pair = model_pair('dnn')
    port_data, jax_data = data_pair(data_dir)
    want = pair['jax'].fit_streaming(jax_data, 'train', batch_size=5000)
    got = pair['torch'].fit_streaming(port_data, 'train', batch_size=5000)
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=0,
                               atol=TRAJECTORY_TOL)
    assert_params_close(pair['torch'], pair['jax'], TRAJECTORY_TOL)


@pytest.mark.parametrize('streamed', [False, True])
def test_population_statistics_match_jax(data_dir, streamed):
    """Batch-norm population statistics from the same parameters: the
    dense pass over the training arrays (a fit of no epochs) and the
    streamed pass, one layer at a time over padded files."""
    pair = model_pair('dnn_bn')
    port_data, jax_data = data_pair(data_dir)
    if streamed:
        pair['jax']._set_population_stats_streaming(jax_data, 'train')
        pair['torch']._set_population_stats_streaming(port_data, 'train')
    else:
        pair['jax'].fit(jax_data.create_dataset('train'), epochs=0)
        pair['torch'].fit(port_data.create_dataset('train'), epochs=0)
    want = flat_jax(pair['jax'])
    for key in ('bn/0/mean', 'bn/0/var', 'bn/1/mean', 'bn/1/var'):
        np.testing.assert_allclose(pair['torch'].params[key].numpy(),
                                   want[key], err_msg=key,
                                   **POPULATION_TOL)


def test_dense_population_equals_streamed_population(data_dir):
    pair = model_pair('dnn_bn')
    port_data, _ = data_pair(data_dir)
    dense = convert.sgd_params_from_numpy(
        'BrainModelDNN', flat_jax(pair['jax']), 'cpu', pair['jax'].config())
    dense.fit(port_data.create_dataset('train'), epochs=0)
    pair['torch']._set_population_stats_streaming(port_data, 'train')
    for key in ('bn/0/mean', 'bn/0/var', 'bn/1/mean', 'bn/1/var'):
        np.testing.assert_allclose(pair['torch'].params[key].numpy(),
                                   dense.params[key].numpy(), err_msg=key,
                                   **POPULATION_TOL)


def test_fits_bump_the_params_version(data_dir):
    """A decoder rebuilds its cached pipeline when the version moves, so
    every fit moves it."""
    model = model_pair('dnn')['torch']
    port_data, _ = data_pair(data_dir)
    seen = [model.params_version]
    model.fit(port_data.create_dataset('train'), epochs=1, batch_size=256)
    seen.append(model.params_version)
    model.fit_streaming(port_data, 'train', **STREAM)
    seen.append(model.params_version)
    assert seen == sorted(set(seen))


def test_dense_fit_pads_the_last_batch_by_wrapping(data_dir):
    """Ceil, not floor: 2000 odd frames in batches of 512 take four
    steps an epoch, the last filled from the permutation's head."""
    model = model_pair('dnn')['torch']
    port_data, _ = data_pair(data_dir)
    steps = []
    step = model._step
    model._step = lambda *args: steps.append(args[2].shape[0]) or step(*args)
    n = port_data.create_dataset('train').num_frames
    model.fit(port_data.create_dataset('train'), epochs=2, batch_size=512)
    assert steps == [512] * (2 * -(-n // 512))


def test_dense_fit_warns_above_the_streaming_threshold(data_dir,
                                                       monkeypatch):
    monkeypatch.setenv('TDT_STREAMING_AUTO_BYTES', '1000')
    model = model_pair('dnn')['torch']
    with pytest.warns(UserWarning, match=r'SGD fit materializes 0\.\d MB'):
        model.fit(data_pair(data_dir)[0].create_dataset('train'))


def test_init_is_seeded_and_he_scaled():
    a, b, c = (BrainModelDNN(num_hidden_list=[64], input_width=400,
                             output_width=1, device='cpu')
               for _ in range(3))
    gens = [torch.Generator().manual_seed(s) for s in (7, 7, 8)]
    params = [m._init_params(g) for m, g in zip((a, b, c), gens)]
    assert torch.equal(params[0]['layers/0/w'], params[1]['layers/0/w'])
    assert not torch.equal(params[0]['layers/0/w'], params[2]['layers/0/w'])
    assert float(params[0]['layers/0/w'].std()) == pytest.approx(
        np.sqrt(2 / 400), rel=0.05)
    assert not params[0]['layers/0/b'].any()


def test_dropout_is_inverted_and_seeded():
    model = BrainModelDNN(num_hidden_list=[2000], input_width=4,
                          output_width=1, dropout=0.25, device='cpu')
    params = model._init_params(torch.Generator().manual_seed(0))
    params['layers/1/w'] = torch.ones((2000, 1))
    x = torch.ones((1, 4))
    outs = [model._forward(params, x, training=True,
                           gen=torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    full = model._forward(params, x, training=True)
    assert float(outs[0]) == pytest.approx(float(full), rel=0.1)


def test_constructor_errors_match_jax():
    for kwargs in (dict(num_hidden_list='8-8'), dict(dropout=1.0)):
        with pytest.raises((TypeError, ValueError)) as want:
            JaxDNN(input_width=4, output_width=1, **kwargs)
        with pytest.raises(type(want.value),
                           match=re.escape(str(want.value))):
            BrainModelDNN(input_width=4, output_width=1, device='cpu',
                          **kwargs)
    assert BrainModelClassifier(num_hidden_list='8-4', input_width=4,
                                input2_width=1, output_width=1,
                                device='cpu').num_hidden_list == [8, 4]


# -- model directories --------------------------------------------------------

@pytest.mark.parametrize('family', sorted(FAMILIES))
@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_model_dirs_load_across_packages(family, writer, tmp_path):
    pair = model_pair(family)
    pair[writer].telluride_metadata = '{"dnn_regressor": "x"}'
    pair[writer].save(str(tmp_path))
    x = inputs()
    if writer == 'jax':
        loaded = load_model(str(tmp_path), 'cpu')
        got = loaded(x).numpy()
        assert type(loaded).__name__ == type(pair['jax']).__name__
        assert loaded.config() == pair['jax'].config()
    else:
        loaded = jax_load_model(str(tmp_path))
        got = np.asarray(loaded.apply(loaded.params, x))
    assert loaded.telluride_metadata == '{"dnn_regressor": "x"}'
    want = np.asarray(pair['jax'].apply(pair['jax'].params, x))
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_TOL)


def test_legacy_dnn_checkpoint_loads(tmp_path):
    """A DNN saved before batch norm kept its layers as 0/w, 0/b."""
    pair = model_pair('dnn')
    pair['jax'].save(str(tmp_path))
    path = str(tmp_path / 'weights.npz')
    with np.load(path) as npz:
        legacy = {k[len('layers/'):]: npz[k] for k in npz.files}
    np.savez(path, **legacy)
    x = inputs()
    want = np.asarray(jax_load_model(str(tmp_path)).apply(
        pair['jax'].params, x))
    np.testing.assert_allclose(load_model(str(tmp_path), 'cpu')(x).numpy(),
                               want, rtol=0, atol=FORWARD_TOL)


def test_missing_weight_raises_the_jax_text(tmp_path):
    pair = model_pair('dnn_bn')
    pair['jax'].save(str(tmp_path))
    path = str(tmp_path / 'weights.npz')
    with np.load(path) as npz:
        kept = {k: npz[k] for k in npz.files if k != 'bn/1/var'}
    np.savez(path, **kept)
    with pytest.raises(ValueError) as want:
        jax_load_model(str(tmp_path))
    with pytest.raises(ValueError) as got:
        load_model(str(tmp_path), 'cpu')
    assert str(got.value) == str(want.value)


# -- the experiment driver ----------------------------------------------------

@pytest.fixture(scope='module')
def trf_dir(tmp_path_factory):
    """The JAX suite's TRF simulation (tests/test_decoding.py:61-73) as
    three TFRecord files with an attend field."""
    d = tmp_path_factory.mktemp('trf')
    rng = np.random.RandomState(42)
    for name in ['trial01', 'trial02', 'trial03']:
        eeg, attended, unattended = test_torch_decoding.test_decoding \
            .simulate_trf(rng, num_frames=3000)
        records.convert_data_to_tfrecords(
            {'eeg': eeg, 'intensity': attended, 'unattended': unattended,
             'attend': np.ones((eeg.shape[0], 1), np.float32)},
            str(d / ('%s.tfrecords' % name)))
    return str(d)


DRIVER_FAMILIES = {
    # tests/test_decoding.py:188-203.
    'fullyconnected': (dict(hidden_units='16', learning_rate=1e-3,
                            epoch_count=20),
                       'pearson_correlation_first', 0.97),
    # tests/test_decoding.py:242-279.
    'classifier': (dict(mismatch_batch=True, input2_field='intensity',
                        post_context=10, input2_post_context=10,
                        hidden_units='16', learning_rate=1e-3,
                        epoch_count=20, batch_size=512),
                   'accuracy', 0.65),
    'dcca': (dict(input2_field='intensity', input2_post_context=5,
                  cca_dimensions=2, hidden_units='8', learning_rate=1e-3,
                  epoch_count=20, regularization_lambda=1e-2,
                  test_metric='cca_pearson_correlation_first'),
             'cca_pearson_correlation_first', 0.9),
}


def _result_keys(text):
    return [line.split(':')[0] for line in text.splitlines()]


@pytest.mark.parametrize('kind', sorted(DRIVER_FAMILIES))
def test_driver_main_matches_the_jax_driver(trf_dir, tmp_path, kind):
    """decoding.main and the JAX driver on the same flags: the same
    results.txt lines (Parameters text and keys), model.json, and each
    package over its family's bar; the DNN and DCCA reach d' > 1 and
    write decoder_model.json, the classifier has no LDA stage."""
    changes, metric, bar = DRIVER_FAMILIES[kind]
    texts, dirs = {}, {}
    for name, module in (('jax', jax_decoding), ('torch', decoding)):
        options = test_torch_decoding._options(
            module, tmp_path / name, trf_dir, dnn_regressor=kind, **changes)
        dirs[name] = options.saved_model_dir
        if name == 'jax':
            _, results, dprime = module.run_decoding_experiment(options)
        else:
            assert decoding.main(test_torch_decoding._argv(options)) == 0
            path, texts[name] = test_torch_decoding._read_results(
                tmp_path / name)
            results = {line.split(': ')[0][len('Final_Testing/'):]:
                       float(line.split(': ')[1])
                       for line in texts[name].splitlines()
                       if line.startswith('Final_')}
            dprime = results['dprime']
        if name == 'jax':
            texts[name] = test_torch_decoding._read_results(
                tmp_path / name)[1]
        assert results[metric] > bar, (name, results)
        if kind == 'classifier':
            assert dprime == 0.0
        else:
            assert dprime > 1.0, (name, dprime)
    assert _result_keys(texts['torch']) == _result_keys(texts['jax'])
    assert texts['torch'].splitlines()[0].replace('/torch/', '/jax/') == \
        texts['jax'].splitlines()[0]
    for name in dirs:
        assert sorted(os.listdir(dirs[name])) == sorted(
            ['model.json', 'weights.npz'] +
            ([] if kind == 'classifier' else ['decoder_model.json']))
    assert load_model(dirs['jax'], 'cpu').config() == \
        jax_load_model(dirs['torch']).config()


def test_classifier_learns_the_reference_corpus(tmp_path):
    """The reference's classifier gate (accuracy above 0.9) in both
    packages on the same corpus and flags."""
    corpus = str(tmp_path / 'corpus')
    ab_reference.write_classifier_corpus(corpus)
    for name, module in (('jax', jax_decoding), ('torch', decoding)):
        flags = ab_reference.learning_classifier_flags(corpus)
        flags.update(summary_dir=str(tmp_path / name), saved_model_dir=None)
        options = module.DecodingOptions().set_from_dict(flags)
        kwargs = {} if name == 'jax' else {'device': 'cpu'}
        _, results, _ = module.run_decoding_experiment(options, **kwargs)
        assert results['accuracy'] > 0.9, (name, results)


def test_streaming_fit_flag_trains_the_dnn_from_files(trf_dir, tmp_path):
    """--streaming_fit reaches the SGD fit (the numpy-seeded stream), and
    its results follow the JAX driver's from the same parameters."""
    options = {name: test_torch_decoding._options(
        module, tmp_path / name, trf_dir, dnn_regressor='fullyconnected',
        hidden_units='8', epoch_count=2, streaming_fit=True,
        saved_model_dir=None)
        for name, module in (('jax', jax_decoding), ('torch', decoding))}
    port_data, jax_data = (
        module.brain_data.create_brain_dataset(
            'tfrecords', 'eeg', 'intensity', frame_rate=100.0,
            pre_context=0, post_context=24, final_batch_size=256,
            shuffle_buffer_size=0, data_dir=trf_dir,
            train_file_pattern='allbut', validate_file_pattern='trial02',
            test_file_pattern='trial02', **extra)
        for module, extra in ((decoding, {'device': 'cpu'}),
                              (jax_decoding, {})))
    jax_model = jax_decoding.create_brain_model(options['jax'],
                                                jax_data.spec_dataset())
    jax_model.params = jax_model._init_params(jax.random.PRNGKey(0))
    port_model = convert.sgd_params_from_numpy(
        'BrainModelDNN', numpy_tree(jax_model.params), 'cpu',
        jax_model.config())
    port_model.compile(learning_rate=options['torch'].learning_rate)
    want = jax_decoding.train_and_test(options['jax'], jax_data, jax_model,
                                       epochs=2)
    got = decoding.train_and_test(options['torch'], port_data, port_model,
                                  epochs=2)
    np.testing.assert_allclose(got[0]['loss'], want[0]['loss'], rtol=0,
                               atol=TRAJECTORY_TOL)
    for key, value in want[1].items():
        assert got[1][key] == pytest.approx(value, abs=TRAJECTORY_TOL)


# -- the slice: chip_smoke.py's phase 14 on the CPU at a small size -----------

def test_phase_14_runs_the_sgd_families_on_the_cpu(tmp_path, monkeypatch):
    """Phase 14 over a small copy of phase 8's corpus (1500 frames a
    file), a 2000-frame stream and an SGD cohort of 600-frame trials,
    with the plain versions on the CPU, where no kernel launches and so
    none is required: its gates hold (d' above 1 for the DNN and the
    DCCA, the classifier above 0.9 on the reference's corpus, the served
    decisions the same, the resumed cohort's CSV the same)."""
    import chip_smoke
    build = tmp_path / 'build'
    for name, value in (('BUILD', build), ('CODELAB_DIR', build / 'codelab'),
                        ('DECODING_DIR', build / 'decoding'),
                        ('SGD_DIR', build / 'sgd')):
        monkeypatch.setattr(chip_smoke, name, str(value))
    monkeypatch.setattr(chip_smoke, 'TRAIN_FRAMES', 1500)
    monkeypatch.setattr(chip_smoke, 'STREAM_FRAMES', 2000)
    monkeypatch.setattr(chip_smoke, 'SWEEP_FRAMES', 600)
    monkeypatch.setattr(chip_smoke, 'require_launched', lambda *args: None)
    chip_smoke.decoding_corpus(
        os.path.join(chip_smoke.DECODING_DIR, 'records'), frames=1500,
        short_dir=os.path.join(chip_smoke.DECODING_DIR, 'records_short'),
        short_frames=1500)
    launches, k1 = chip_smoke.phase_sgd(None, 'cpu', 'no card')
    assert set(launches.values()) == {0} and k1 == {}
    for kind in ('fullyconnected', 'dcca', 'classifier'):
        assert os.path.isfile(os.path.join(chip_smoke.SGD_DIR,
                                           kind + '_model', 'model.json'))
