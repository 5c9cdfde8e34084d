"""Reference SavedModel migration of the PyTorch port vs the JAX package.

The same checkpoint bundles (written by the JAX writer, in the layouts
models/migrate.py reads) go through both packages'
load_reference_saved_model: the models must hold the same weights and
telluride strings and save the same model.json and weights.npz, and
every refusal must raise the same exception with the same text. The
decoder of a migrated directory (create_decoder, load_decoding_model)
must be the JAX package's class and score the same frames the same:
rtol 1e-4 / atol 1e-4, the float32 bound of the fused decode that
tests/test_torch_infer_decoder.py uses. The reference behaviours the
port copies (ROADMAP §3) are pinned on both sides.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from test_fuzz_codecs import N_MUTANTS, _mutate  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from telluride_decoding_tpu.cli import infer as jax_infer_cli  # noqa: E402
from telluride_decoding_tpu.cli import migrate_saved_model as jax_cli  # noqa: E402
from telluride_decoding_tpu.decode import infer_decoder as jax_decoder  # noqa: E402
from telluride_decoding_tpu.io import keras_h5 as jax_h5  # noqa: E402
from telluride_decoding_tpu.io import saved_model_pb as jax_pb  # noqa: E402
from telluride_decoding_tpu.io import tf_checkpoint as jax_ckpt  # noqa: E402
from telluride_decoding_tpu.models import BrainModelCCA as JaxCCA  # noqa: E402
from telluride_decoding_tpu.models import migrate as jax_migrate  # noqa: E402
from telluride_decoding_tpu.ops.lagstack import lag_stack_np  # noqa: E402
from telluride_decoding_torch.cli import migrate_saved_model  # noqa: E402
from telluride_decoding_torch.cli import serve  # noqa: E402
from telluride_decoding_torch.decode import infer_decoder  # noqa: E402
from telluride_decoding_torch.io import saved_model_pb  # noqa: E402
from telluride_decoding_torch.models import convert, migrate  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
VALUE = '/.ATTRIBUTES/VARIABLE_VALUE'
FLAGS = {'pre_context': 0, 'post_context': 4, 'input2_pre_context': 2,
         'input2_post_context': 2, 'dnn_regressor': 'cca'}
CHANNELS, DIMS = 8, 3
CONTEXTS = (0, 4, 2, 2)


def outcome(fn, *args, **kwargs):
    """('raised', class name, text) or ('returned', value); a CLI's
    usage error (SystemExit) counts as raised."""
    try:
        return 'returned', fn(*args, **kwargs)
    except (Exception, SystemExit) as error:  # noqa: BLE001
        return 'raised', type(error).__name__, str(error)


def model_state(model):
    """Class name, float32 weights by name and the telluride strings."""
    params = {k: np.asarray(v.cpu().numpy() if hasattr(v, 'cpu') else v)
              for k, v in model.params.items()}
    return (type(model).__name__, params, model.telluride_metadata,
            model.telluride_inputs, model.telluride_output)


def assert_same_models(got, want):
    g, w = model_state(got), model_state(want)
    assert g[0] == w[0] and g[2:] == w[2:]
    assert sorted(g[1]) == sorted(w[1])
    for key, value in w[1].items():
        assert g[1][key].dtype == value.dtype == np.float32
        np.testing.assert_array_equal(g[1][key], value)


def migrate_both(path):
    """Both packages' outcome on a SavedModel directory; raises unless
    they agree (the same error text, or the same model)."""
    got = outcome(migrate.load_reference_saved_model, path, device='cpu')
    want = outcome(jax_migrate.load_reference_saved_model, path)
    assert got[0] == want[0], (got, want)
    if got[0] == 'raised':
        assert got[1:] == want[1:]
    else:
        assert_same_models(got[1], want[1])
    return got, want


def saved_files(model_dir):
    """model.json as a dict, and weights.npz's arrays."""
    with open(os.path.join(model_dir, 'model.json')) as f:
        meta = json.load(f)
    with np.load(os.path.join(model_dir, 'weights.npz')) as npz:
        return meta, {k: npz[k] for k in npz.files}


def assert_same_saves(got_dir, want_dir):
    got, want = saved_files(got_dir), saved_files(want_dir)
    assert got[0] == want[0]
    assert sorted(got[1]) == sorted(want[1])
    for key, value in want[1].items():
        assert got[1][key].dtype == value.dtype
        np.testing.assert_array_equal(got[1][key], value)


def weights(rng, kind):
    if kind == 'linear':
        return {'w': rng.randn(6, 2).astype(np.float32),
                'b': rng.randn(2).astype(np.float32)}
    return {'mean1': rng.randn(1, 6).astype(np.float32),
            'mean2': rng.randn(1, 4).astype(np.float32),
            'rot1': rng.randn(6, 3).astype(np.float32),
            'rot2': rng.randn(4, 3).astype(np.float32)}


STRINGS = {
    'none': {},
    'all': {'telluride_metadata': json.dumps(
                {'dnn_regressor': 'cca', 'post_context': 4}),
            'telluride_inputs': json.dumps({'input_1': [None, 6]}),
            'telluride_output': json.dumps([None, 2])},
    'shapes_only': {'telluride_inputs': '{"input_1": [null, 6]}'},
    'invalid_json': {'telluride_metadata': '{not json',
                     'telluride_output': '[null, 2]'},
    'linear_family': {'telluride_metadata': '{"dnn_regressor": "linear"}'},
}
# Names of the weights in each layout: positional in tf_keras's creation
# order, or named as a functional model's checkpoint names them.
LAYOUTS = {
    ('linear', 'named'): {'w': '_layer/kernel', 'b': '_layer/bias'},
    ('linear', 'positional'): {'w': 'variables/0', 'b': 'variables/1'},
    ('cca', 'named'): {'mean1': '_cca/mean1', 'mean2': '_cca/mean2',
                       'rot1': '_cca/rot1', 'rot2': '_cca/rot2'},
    ('cca', 'positional'): {'mean1': 'variables/0', 'mean2': 'variables/1',
                            'rot1': 'variables/2', 'rot2': 'variables/3'},
}


def write_saved_model(path, tensors, strings=None):
    """A SavedModel directory: an empty saved_model.pb beside a bundle of
    ``tensors`` (name: array) and the telluride strings, by the JAX
    writer."""
    os.makedirs(os.path.join(path, 'variables'), exist_ok=True)
    open(os.path.join(path, 'saved_model.pb'), 'wb').close()
    tensors = {name + VALUE: value for name, value in tensors.items()}
    for attr, text in (strings or {}).items():
        tensors[attr + VALUE] = np.array(text.encode(), dtype=object)
    jax_ckpt.write_tensor_bundle(os.path.join(path, 'variables',
                                              'variables'), tensors)
    return str(path)


def layout_dir(path, kind, layout, strings='none', seed=0):
    flat = weights(np.random.RandomState(seed), kind)
    names = LAYOUTS[(kind, layout)]
    return write_saved_model(path, {names[k]: v for k, v in flat.items()},
                             STRINGS[strings]), flat


# -- layouts ------------------------------------------------------------------

@pytest.mark.parametrize('strings', sorted(STRINGS))
@pytest.mark.parametrize('kind,layout', sorted(LAYOUTS))
def test_layouts_migrate_and_save_as_jax(kind, layout, strings, tmp_path):
    path, flat = layout_dir(tmp_path / 'sm', kind, layout, strings)
    got, want = migrate_both(path)
    assert got[0] == 'returned'
    model = got[1]
    for key, value in flat.items():
        np.testing.assert_array_equal(
            model.params[key].numpy(), value.reshape(model.params[key].shape))
    if strings == 'invalid_json':
        assert model.telluride_metadata is None
        assert model.telluride_output == '[null, 2]'
    model.save(str(tmp_path / 'torch'))
    want[1].save(str(tmp_path / 'jax'))
    assert_same_saves(str(tmp_path / 'torch'), str(tmp_path / 'jax'))
    assert saved_files(str(tmp_path / 'torch'))[0]['config'][
        'regularization_lambda'] == 0.0


@pytest.mark.parametrize('family', ['fullyconnected', 'classifier', 'dcca'])
def test_sgd_family_is_refused_alike(family, tmp_path):
    path, _ = layout_dir(tmp_path / 'sm', 'linear', 'named')
    write_saved_model(path, {'_layer/kernel': np.ones((3, 1), np.float32)},
                      {'telluride_metadata': json.dumps(
                          {'dnn_regressor': family})})
    got, _ = migrate_both(path)
    assert got[1] == 'ValueError' and repr(family) in got[2]


def test_two_kernels_are_refused_alike(tmp_path):
    path = write_saved_model(tmp_path / 'sm', {
        'layer_with_weights-0/kernel': np.ones((4, 3), np.float32),
        'layer_with_weights-1/kernel': np.ones((3, 1), np.float32),
        'layer_with_weights-1/kernel/.OPTIMIZER_SLOT/m':
            np.ones((3, 1), np.float32)})
    got, _ = migrate_both(path)
    assert got[1] == 'ValueError' and 'has 2 dense kernels' in got[2]


@pytest.mark.parametrize('case', ['no_checkpoint', 'unrecognized',
                                  'positional_mismatch', 'rot1_no_mean1',
                                  'narrow_cca', 'metadata_not_a_dict'])
def test_malformed_directories_fail_alike(case, tmp_path):
    path = str(tmp_path / 'sm')
    if case == 'no_checkpoint':
        os.makedirs(path)
    elif case == 'unrecognized':
        write_saved_model(path, {'some/thing': np.ones(3, np.float32)})
    elif case == 'positional_mismatch':
        write_saved_model(path, {'variables/0': np.ones((4, 3), np.float32),
                                 'variables/1': np.ones(2, np.float32)})
    elif case == 'rot1_no_mean1':
        write_saved_model(path, {'cca/rot1': np.ones((4, 3), np.float32)})
    elif case == 'narrow_cca':
        write_saved_model(path, {
            'cca/mean1': np.ones((1, 1), np.float32),
            'cca/mean2': np.ones((1, 4), np.float32),
            'cca/rot1': np.ones((1, 3), np.float32),
            'cca/rot2': np.ones((4, 3), np.float32)})
    else:
        write_saved_model(path, {'dense/kernel': np.ones((4, 1), np.float32)},
                          {'telluride_metadata': '[1, 2]'})
    got, _ = migrate_both(path)
    assert got[0] == 'raised'


# -- reference behaviours the port copies (ROADMAP §3), on both sides ----------

def cca_models(seed=0):
    flat = weights(np.random.RandomState(seed), 'cca')
    jax_model = JaxCCA(cca_dims=3, input1_width=6, input2_width=4)
    jax_model.params = {k: jnp.asarray(v) for k, v in flat.items()}
    torch_model = convert.cca_params_from_numpy(flat, 'cpu')
    for model in (jax_model, torch_model):
        model.telluride_metadata = json.dumps(FLAGS)
    return {'jax': jax_model, 'torch': torch_model}


EXPORTS = {'jax': jax_pb.export_saved_model,
           'torch': saved_model_pb.export_saved_model}
MIGRATES = {'jax': jax_migrate.load_reference_saved_model,
            'torch': lambda path: migrate.load_reference_saved_model(
                path, device='cpu')}


@pytest.mark.parametrize('package', sorted(EXPORTS))
def test_exported_cca_saved_model_is_refused(package, tmp_path):
    """A CCA model written by export_saved_model has two Dense kernels
    (rot1, rot2), so migration refuses it as a DNN, with the text phase
    13 of chip_smoke.py requires on the card."""
    path = str(tmp_path / 'cca_sm')
    EXPORTS[package](cca_models()[package], path)
    with pytest.raises(ValueError) as error:
        MIGRATES[package](path)
    assert str(error.value) == chip_smoke.CCA_EXPORT_REFUSAL


DECODER_CLASSES = {'jax': jax_decoder, 'torch': infer_decoder}


def create(package, path):
    if package == 'jax':
        return jax_decoder.create_decoder(path, reduction='lda')
    return infer_decoder.create_decoder(path, reduction='lda', device='cpu')


@pytest.mark.parametrize('package', sorted(DECODER_CLASSES))
def test_positional_bundle_decoder_is_chosen_by_name(package, tmp_path):
    """Positional keys hold neither rot1 nor kernel: the directory's name
    decides, and a neutral name raises."""
    module = DECODER_CLASSES[package]
    for name, want in (('pos_cca', module.CCADecoder),
                       ('pos_linear', module.LinearRegressionDecoder),
                       ('cca_but_linear', module.LinearRegressionDecoder)):
        path, _ = layout_dir(tmp_path / name, 'cca', 'positional')
        assert type(create(package, path)) is want
    path, _ = layout_dir(tmp_path / 'pos_model', 'cca', 'positional')
    with pytest.raises(ValueError, match='Couldn\'t determine model type'):
        create(package, path)


@pytest.mark.parametrize('package', sorted(DECODER_CLASSES))
def test_decoder_sniff_swallows_a_broken_bundle(package, tmp_path):
    """A SavedModel directory whose bundle does not read falls through to
    the name without an error."""
    module = DECODER_CLASSES[package]
    for name in ('broken_cca', 'broken_model'):
        path = tmp_path / name
        os.makedirs(path / 'variables')
        (path / 'saved_model.pb').write_bytes(b'')
        (path / 'variables' / 'variables.index').write_bytes(b'garbage')
    assert type(create(package, str(tmp_path / 'broken_cca'))) is \
        module.CCADecoder
    with pytest.raises(ValueError, match='Couldn\'t determine model type'):
        create(package, str(tmp_path / 'broken_model'))


# -- the decoder ----------------------------------------------------------------

@pytest.mark.parametrize('kind,layout', sorted(LAYOUTS))
def test_create_decoder_picks_the_jax_class(kind, layout, tmp_path):
    path, _ = layout_dir(tmp_path / 'model', kind, layout)
    got, want = (outcome(create, p, path) for p in ('torch', 'jax'))
    assert got[0] == want[0]
    if got[0] == 'raised':
        assert got[1:] == want[1:]
    else:
        assert type(got[1]).__name__ == type(want[1]).__name__


def reference_dir(path, train):
    """A JAX-trained CCA model and decoder, written as the reference's
    subclassed CCA is (saved_model.pb and keras_metadata.pb of
    export_saved_model, variables/ positional, decoder_model.json);
    returns (reference dir, native dir)."""
    pre, post, pre2, post2 = CONTEXTS

    def stacked(speaker):
        return [({'input_1': lag_stack_np(rec[0], pre, post),
                  'input_2': lag_stack_np(rec[speaker], pre2, post2)},
                 rec[speaker]) for rec in train]
    model = JaxCCA(cca_dims=DIMS, regularization_lambda=1e-3,
                   input1_width=CHANNELS * 5, input2_width=5)
    model.fit(stacked(1))
    decoder = jax_decoder.CCADecoder(model, reduction='lda')
    decoder.train(stacked(2), stacked(1), window_size=100)
    model.add_metadata(FLAGS)
    native = os.path.join(path, 'native_cca')
    model.save(native)
    decoder.save_parameters(os.path.join(native, 'decoder_model.json'))
    ref = os.path.join(path, 'reference_cca')
    jax_pb.export_saved_model(model, ref)
    shutil.rmtree(os.path.join(ref, 'variables'))
    jax_h5.export_saved_model_variables(model, os.path.join(ref,
                                                            'variables'))
    shutil.copyfile(os.path.join(native, 'decoder_model.json'),
                    os.path.join(ref, 'decoder_model.json'))
    return ref, native


def test_migrated_cca_directory_scores_as_jax(tmp_path):
    train, _ = chip_smoke.synthetic_recordings(3, CHANNELS, 2, 2000, 100)
    ref, native = reference_dir(str(tmp_path), train)
    pre, post, pre2, post2 = CONTEXTS
    x1 = lag_stack_np(train[0][0], pre, post)[:500]
    x2a = lag_stack_np(train[0][1], pre2, post2)[:500]
    x2b = lag_stack_np(train[0][2], pre2, post2)[:500]
    y = train[0][1][:500]
    want = jax_infer_cli.load_model(ref, 'lda')
    got = serve.load_model(ref, 'lda', 'cpu')
    assert type(got).__name__ == type(want).__name__ == 'CCADecoder'
    assert got._decoding_model_params == want._decoding_model_params == FLAGS
    scores = got.infer_one({'input_1': x1, 'input_2': x2a}, y)
    np.testing.assert_allclose(
        scores, want.infer_one({'input_1': x1, 'input_2': x2a}, y), **TOL)
    for g, w in zip(got.infer_pair(x1, x2a, x2b, y, y),
                    want.infer_pair(x1, x2a, x2b, y, y)):
        np.testing.assert_allclose(g, w, **TOL)
    # The same float32 weights as the native directory: the same scores.
    np.testing.assert_array_equal(
        scores, serve.load_model(native, 'lda', 'cpu').infer_one(
            {'input_1': x1, 'input_2': x2a}, y))


@pytest.mark.parametrize('case', ['native', 'saved_model', 'neither'])
def test_load_decoding_model_takes_what_jax_takes(case, tmp_path):
    path = str(tmp_path / 'model_cca')
    if case == 'native':
        convert.cca_params_from_numpy(weights(np.random.RandomState(1),
                                              'cca'), 'cpu').save(path)
    elif case == 'saved_model':
        layout_dir(path, 'cca', 'positional', 'all')
    else:
        os.makedirs(path)
    got = outcome(infer_decoder.CCADecoder(reduction='lda',
                                           device='cpu').load_decoding_model,
                  path)
    want = outcome(jax_decoder.CCADecoder(reduction='lda')
                   .load_decoding_model, path)
    assert got[0] == want[0] and got[1:2] == want[1:2]


# -- fuzz parity (tests/test_fuzz_codecs.py's migration loop) --------------------

@pytest.mark.parametrize('seed', [11, 12])
def test_mutated_saved_model_migration_matches_jax(seed, tmp_path):
    """Seed 11 is tests/test_fuzz_codecs.py's loop over its valid linear
    bundle; seed 12 the same loop over a positional CCA bundle."""
    valid = tmp_path / 'valid'
    if seed == 11:
        rng = np.random.RandomState(0)
        write_saved_model(valid, {
            'model/layer/kernel': rng.randn(4, 3).astype(np.float32),
            'model/layer/bias': rng.randn(3)},
            {'telluride_metadata': '{"dnn_regressor": "linear"}'})
    else:
        layout_dir(valid, 'cca', 'positional', 'all')
    prefix = str(valid / 'variables' / 'variables')
    index = open(prefix + '.index', 'rb').read()
    data = open(prefix + '.data-00000-of-00001', 'rb').read()
    sm = tmp_path / 'sm'
    vdir = sm / 'variables'
    vdir.mkdir(parents=True)
    rng = np.random.RandomState(seed)
    outcomes = set()
    for i in range(N_MUTANTS // 2):
        with open(vdir / 'variables.index', 'wb') as f:
            f.write(_mutate(rng, index) if i % 2 == 0 else index)
        with open(vdir / 'variables.data-00000-of-00001', 'wb') as f:
            f.write(data if i % 2 == 0 else _mutate(rng, data))
        got, _ = migrate_both(str(sm))
        outcomes.add(got[1] if got[0] == 'raised' else got[0])
    assert 'returned' in outcomes and len(outcomes) > 1, outcomes


# -- the CLI ----------------------------------------------------------------------

@pytest.mark.parametrize('argv', [[], ['one'], ['a', 'b', 'c'],
                                  ['--device', 'cpu', 'a']])
def test_cli_usage_errors_match_jax(argv, tmp_path):
    jax_argv = [a for a in argv if a not in ('--device', 'cpu')]
    got = outcome(migrate_saved_model.app_main, argv)
    want = outcome(jax_cli.app_main, jax_argv)
    assert got == want and got[1] == 'SystemExit'


def test_cli_refuses_a_directory_without_saved_model_pb(tmp_path):
    argv = [str(tmp_path), str(tmp_path / 'dst')]
    got = outcome(migrate_saved_model.app_main, ['--device', 'cpu'] + argv)
    assert got == outcome(jax_cli.app_main, argv)
    assert 'no saved_model.pb' in got[2]


@pytest.mark.parametrize('kind', ['linear', 'cca'])
def test_cli_writes_what_jax_writes(kind, tmp_path, capsys):
    src, _ = layout_dir(tmp_path / 'src', kind, 'positional', 'all')
    with open(os.path.join(src, 'decoder_model.json'), 'w') as f:
        f.write('{"correlation_params": [1, 2]}')
    migrate_saved_model.app_main(['--device', 'cpu', src,
                                  str(tmp_path / 'torch')])
    torch_out = capsys.readouterr().out
    jax_cli.app_main([src, str(tmp_path / 'jax')])
    assert torch_out.replace('torch', 'jax') == capsys.readouterr().out
    assert_same_saves(str(tmp_path / 'torch'), str(tmp_path / 'jax'))
    for side in ('torch', 'jax'):
        with open(tmp_path / side / 'decoder_model.json') as f:
            assert f.read() == '{"correlation_params": [1, 2]}'


def test_cli_device_defaults_to_cuda():
    assert migrate_saved_model.pop_device(['a', 'b']) == ('cuda', ['a', 'b'])
    assert migrate_saved_model.pop_device(['a', '--device=cpu', 'b']) == (
        'cpu', ['a', 'b'])


# -- the slice: chip_smoke.py's phase 13 on the CPU at a small size -------------

def test_phase_13_serves_the_reference_layout_on_the_cpu(tmp_path,
                                                         monkeypatch):
    """Phase 13 over small copies of phases 4 and 8 (8 EEG channels, 3000
    frames a file; a 1500-frame decoding corpus), with the plain versions
    on the CPU, where no kernel launches and so none is required; then
    the reference-layout directory it wrote scores the served stream as
    the JAX package's decoder of it does."""
    build = tmp_path / 'build'
    monkeypatch.setattr(chip_smoke, 'BUILD', str(build))
    monkeypatch.setattr(chip_smoke, 'CODELAB_DIR', str(build / 'codelab'))
    monkeypatch.setattr(chip_smoke, 'DECODING_DIR', str(build / 'decoding'))
    monkeypatch.setattr(chip_smoke, 'require_launched', lambda *args: None)
    chip_smoke.run_slice('cpu', chip_smoke.CODELAB_DIR, channels=CHANNELS,
                         files=2, frames=3000, stream_frames=2000)
    records = os.path.join(chip_smoke.DECODING_DIR, 'records')
    test_file = chip_smoke.decoding_corpus(records, frames=1500)
    chip_smoke.run_decoding('linear', records, chip_smoke.DECODING_DIR,
                            'cpu', test_file)
    launches = chip_smoke.phase_model_files(None, 'cpu', 'no card')
    assert launches['fused_cca_decode'] == 0
    reference = str(build / 'model_files' / 'reference_cca')
    with np.load(os.path.join(chip_smoke.CODELAB_DIR, 'stream.npz')) as data:
        eeg, a1, a2 = data['eeg'], data['audio1'], data['audio2']
    pre, post = chip_smoke.PRE, chip_smoke.POST
    pre2, post2 = chip_smoke.IN2_PRE, chip_smoke.IN2_POST
    n = eeg.shape[0] - max(post, post2)
    frames = (lag_stack_np(eeg, pre, post)[:n],
              lag_stack_np(a1, pre2, post2)[:n],
              lag_stack_np(a2, pre2, post2)[:n], a1[:n], a2[:n])
    got = serve.load_model(reference, 'lda', 'cpu').infer_pair(*frames)
    want = jax_infer_cli.load_model(reference, 'lda').infer_pair(*frames)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
