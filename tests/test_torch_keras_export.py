"""Keras and SavedModel exporters of the PyTorch port vs the JAX package.

The same float32 weights, in a JAX model and in the port's, go through
both packages' exporters: export_saved_model and
export_saved_model_variables must write byte-identical files, and
export_keras_h5 the same HDF5 structure (attributes, model_config JSON,
dataset names and bytes; HDF5 may stamp times, so the parsed file is
compared, not its bytes) and an identical ``.telluride.json`` sidecar.
The export CLI must give the JAX CLI's usage errors and outputs. A
linear SavedModel written by the port migrates back with the same bits.
"""

import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from telluride_decoding_tpu.cli import export_keras as jax_cli
from telluride_decoding_tpu.io import keras_h5 as jax_h5
from telluride_decoding_tpu.io import saved_model_pb as jax_pb
from telluride_decoding_tpu.models import BrainModelCCA as JaxCCA
from telluride_decoding_tpu.models import BrainModelClassifier as JaxClassifier
from telluride_decoding_tpu.models import BrainModelDCCA as JaxDCCA
from telluride_decoding_tpu.models import BrainModelDNN as JaxDNN
from telluride_decoding_tpu.models import (
    BrainModelLinearRegression as JaxLinear)
from telluride_decoding_torch.cli import export_keras
from telluride_decoding_torch.io import keras_h5, saved_model_pb
from telluride_decoding_torch.models import convert, migrate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRINGS = {
    'none': {},
    'all': {'telluride_metadata': json.dumps({'dnn_regressor': 'cca',
                                              'post_context': 4}),
            'telluride_inputs': json.dumps({'input_1': [None, 12]}),
            'telluride_output': json.dumps([None, 2])},
    'shapes_only': {'telluride_inputs': '{"input_1": [null, 12]}'},
}
SAVED_MODEL_FILES = ('saved_model.pb', 'keras_metadata.pb',
                     'variables/variables.index',
                     'variables/variables.data-00000-of-00001')


# The SGD families: (JAX class, constructor config) at small widths.
SGD_FAMILIES = {
    'dnn': (JaxDNN, dict(num_hidden_list=[8, 8], input_width=12,
                         output_width=1)),
    'dnn_bn': (JaxDNN, dict(num_hidden_list=[8, 8], input_width=12,
                            output_width=1, batch_norm=True)),
    'classifier': (JaxClassifier, dict(num_hidden_list=[8],
                                       input_width=12, input2_width=5,
                                       output_width=1)),
    'dcca': (JaxDCCA, dict(cca_dims=3, hidden_units=[8, 8],
                           input1_width=12, input2_width=5)),
}
KINDS = ['linear', 'cca'] + sorted(SGD_FAMILIES)


def models(kind, strings='all', seed=0):
    """{'jax': model, 'torch': model} holding the same float32 weights
    and telluride strings (random ones for the SGD families, batch-norm
    statistics and the DCCA's final CCA included)."""
    rng = np.random.RandomState(seed)
    if kind in SGD_FAMILIES:
        cls, config = SGD_FAMILIES[kind]
        jax_model = cls(**config)
        template = jax_model._init_params(jax.random.PRNGKey(seed))
        flat = {k: rng.randn(*np.shape(v)).astype(np.float32)
                for k, v in convert.flat_params(template).items()}
        flat.update({k: 0.5 + rng.rand(*v.shape).astype(np.float32)
                     for k, v in flat.items() if k.endswith('/var')})
        jax_model._restore_params(flat)
        torch_model = convert.sgd_params_from_numpy(
            cls.__name__, flat, 'cpu', jax_model.config())
    elif kind == 'linear':
        flat = {'w': rng.randn(12, 2).astype(np.float32),
                'b': rng.randn(2).astype(np.float32)}
        jax_model = JaxLinear(input_width=12, output_width=2)
        torch_model = convert.linear_params_from_numpy(flat, 'cpu')
    else:
        flat = {'mean1': rng.randn(1, 12).astype(np.float32),
                'mean2': rng.randn(1, 5).astype(np.float32),
                'rot1': rng.randn(12, 3).astype(np.float32),
                'rot2': rng.randn(5, 3).astype(np.float32)}
        jax_model = JaxCCA(cca_dims=3, input1_width=12, input2_width=5)
        torch_model = convert.cca_params_from_numpy(flat, 'cpu')
    if kind in ('linear', 'cca'):
        jax_model.params = {k: jnp.asarray(v) for k, v in flat.items()}
    for model in (jax_model, torch_model):
        for attr, text in STRINGS[strings].items():
            setattr(model, attr, text)
    return {'jax': jax_model, 'torch': torch_model}


def read(path):
    with open(path, 'rb') as f:
        return f.read()


def same_tree(got_dir, want_dir):
    """Relative paths and bytes of every file under two directories."""
    def tree(root):
        out = {}
        for base, dirs, names in os.walk(root):
            for name in dirs + names:
                full = os.path.join(base, name)
                rel = os.path.relpath(full, root)
                out[rel] = None if os.path.isdir(full) else read(full)
        return out
    return tree(got_dir) == tree(want_dir)


def h5_structure(path):
    """Every attribute, group and dataset of an HDF5 file, parsed."""
    out = {}

    def attrs(obj):
        return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                for k, v in obj.attrs.items()}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = ('dataset', obj.dtype.str, obj.shape,
                         obj[()].tobytes(), attrs(obj))
        else:
            out[name] = ('group', attrs(obj))
    with h5py.File(path, 'r') as f:
        out['/'] = ('root', attrs(f))
        f.visititems(visit)
    config = json.loads(out['/'][1]['model_config'])
    return out, config


# -- export_saved_model and export_saved_model_variables ------------------------

@pytest.mark.parametrize('strings', sorted(STRINGS))
@pytest.mark.parametrize('kind', KINDS)
def test_saved_model_bytes_match_jax(kind, strings, tmp_path):
    pair = models(kind, strings)
    saved_model_pb.export_saved_model(pair['torch'], str(tmp_path / 'torch'))
    jax_pb.export_saved_model(pair['jax'], str(tmp_path / 'jax'))
    for rel in SAVED_MODEL_FILES:
        assert read(tmp_path / 'torch' / rel) == read(tmp_path / 'jax' / rel)
    assert same_tree(str(tmp_path / 'torch'), str(tmp_path / 'jax'))


@pytest.mark.parametrize('strings', sorted(STRINGS))
@pytest.mark.parametrize('kind', ['linear', 'cca'])
def test_saved_model_variables_bytes_match_jax(kind, strings, tmp_path):
    pair = models(kind, strings)
    keras_h5.export_saved_model_variables(pair['torch'],
                                          str(tmp_path / 'torch'))
    jax_h5.export_saved_model_variables(pair['jax'], str(tmp_path / 'jax'))
    assert same_tree(str(tmp_path / 'torch'), str(tmp_path / 'jax'))
    assert sorted(os.listdir(tmp_path / 'torch')) == [
        'variables.data-00000-of-00001', 'variables.index']


def test_linear_saved_model_migrates_back_bit_for_bit(tmp_path):
    model = models('linear')['torch']
    saved_model_pb.export_saved_model(model, str(tmp_path / 'sm'))
    back = migrate.load_reference_saved_model(str(tmp_path / 'sm'),
                                              device='cpu')
    for key in ('w', 'b'):
        assert back.params[key].numpy().tobytes() == \
            model.params[key].numpy().tobytes()
    x = np.random.RandomState(1).randn(16, 12).astype(np.float32)
    assert np.array_equal(back({'input_1': x}).numpy(),
                          model({'input_1': x}).numpy())
    assert back.telluride_metadata == model.telluride_metadata


# -- export_keras_h5 ---------------------------------------------------------------

@pytest.mark.parametrize('strings', sorted(STRINGS))
@pytest.mark.parametrize('kind', KINDS)
def test_h5_structure_matches_jax(kind, strings, tmp_path):
    pair = models(kind, strings)
    keras_h5.export_keras_h5(pair['torch'], str(tmp_path / 'torch.h5'))
    jax_h5.export_keras_h5(pair['jax'], str(tmp_path / 'jax.h5'))
    got, got_config = h5_structure(str(tmp_path / 'torch.h5'))
    want, want_config = h5_structure(str(tmp_path / 'jax.h5'))
    assert got_config == want_config
    assert got == want
    sidecars = [os.path.exists(tmp_path / (side + '.telluride.json'))
                for side in ('torch', 'jax')]
    assert sidecars == [strings != 'none'] * 2
    if strings != 'none':
        assert read(tmp_path / 'torch.telluride.json') == \
            read(tmp_path / 'jax.telluride.json')


def test_h5_sidecar_of_a_path_without_h5_suffix(tmp_path):
    pair = models('linear')
    keras_h5.export_keras_h5(pair['torch'], str(tmp_path / 'torch.keras'))
    jax_h5.export_keras_h5(pair['jax'], str(tmp_path / 'jax.keras'))
    assert read(tmp_path / 'torch.keras.telluride.json') == \
        read(tmp_path / 'jax.keras.telluride.json')


def test_h5_export_names_h5py_when_it_is_missing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'h5py', None)
    with pytest.raises(ImportError, match='h5py'):
        keras_h5.export_keras_h5(models('linear')['torch'],
                                 str(tmp_path / 'm.h5'))


@pytest.mark.parametrize('name', ['_input_layer', '_dense_layer',
                                  '_batchnorm_layer', '_concat_layer'])
def test_layer_configs_match_jax(name):
    args = {'_input_layer': ('input_1', 7),
            '_dense_layer': ('dense', 3, 'relu', 'input_1'),
            '_batchnorm_layer': ('bn', 'dense'),
            '_concat_layer': ('concatenate', ['a', 'b'])}[name]
    assert getattr(keras_h5, name)(*args) == getattr(jax_h5, name)(*args)


# -- refusals --------------------------------------------------------------------

def unfit(package):
    if package == 'jax':
        return JaxLinear(input_width=4, output_width=1)
    return convert.linear_params_from_numpy({}, 'cpu', {
        'regularization_lambda': 0.0, 'input_width': 4, 'output_width': 1})


class BrainModelOther:
    """A model class no exporter covers."""

    params = {'w': None}


EXPORTERS = {
    'saved_model': (saved_model_pb.export_saved_model,
                    jax_pb.export_saved_model),
    'h5': (keras_h5.export_keras_h5, jax_h5.export_keras_h5),
    'variables': (keras_h5.export_saved_model_variables,
                  jax_h5.export_saved_model_variables),
}


@pytest.mark.parametrize('model,exporter', [
    (model, exporter) for model in ('unfit', 'other')
    for exporter in sorted(EXPORTERS)] + [
    (model, 'variables') for model in sorted(SGD_FAMILIES)])
def test_refusals_match_jax(exporter, model, tmp_path):
    """An unfit model, a class no exporter covers and, for the
    positional variables export, the SGD families."""
    ours, theirs = EXPORTERS[exporter]
    got = want = None
    for fn, package in ((ours, 'torch'), (theirs, 'jax')):
        subject = (unfit(package) if model == 'unfit' else
                   BrainModelOther() if model == 'other' else
                   models(model)[package])
        try:
            fn(subject, str(tmp_path / ('%s_out' % package)))
            result = 'returned'
        except Exception as error:  # noqa: BLE001 - compared below
            result = (type(error).__name__, str(error))
        if package == 'torch':
            got = result
        else:
            want = result
    assert got == want


# -- the CLI ----------------------------------------------------------------------

def cli_outcome(app_main, argv):
    try:
        app_main(argv)
        return 'returned'
    except SystemExit as error:
        return 'SystemExit', str(error)


@pytest.mark.parametrize('argv', [[], ['a'], ['a', 'b', 'c'],
                                  ['--variables', '--saved-model', 'a', 'b'],
                                  ['nowhere', 'dst.h5'],
                                  ['--saved-model', 'nowhere', 'dst']])
def test_cli_usage_errors_match_jax(argv, tmp_path):
    got = cli_outcome(export_keras.app_main, ['--device', 'cpu'] + argv)
    assert got == cli_outcome(jax_cli.app_main, argv)
    assert got[0] == 'SystemExit'


def native_dir(path, kind):
    """A native model directory (written by the JAX package) with a
    decoder_model.json."""
    models(kind)['jax'].save(str(path))
    (path / 'decoder_model.json').write_text('{"lda_params": [0.5]}')
    return str(path)


@pytest.mark.parametrize('kind,mode', [
    (kind, mode) for kind in ('linear', 'cca')
    for mode in ('h5', 'saved-model', 'variables')] + [
    (kind, mode) for kind in ('dnn_bn', 'dcca')
    for mode in ('h5', 'saved-model')])
def test_cli_writes_what_jax_writes(kind, mode, tmp_path, capsys):
    src = native_dir(tmp_path / 'src', kind)
    flags = [] if mode == 'h5' else ['--' + mode]
    dst = {side: str(tmp_path / side / ('out.h5' if mode == 'h5' else 'out'))
           for side in ('torch', 'jax')}
    for side in dst:
        os.makedirs(os.path.dirname(dst[side]))
    export_keras.app_main(flags + ['--device', 'cpu', src, dst['torch']])
    torch_out = capsys.readouterr().out
    jax_cli.app_main(flags + [src, dst['jax']])
    assert torch_out.replace('/torch/', '/jax/') == capsys.readouterr().out
    if mode == 'h5':
        assert h5_structure(dst['torch']) == h5_structure(dst['jax'])
        for sidecar in ('out.telluride.json', 'out.decoder_model.json'):
            assert read(tmp_path / 'torch' / sidecar) == \
                read(tmp_path / 'jax' / sidecar)
    else:
        assert same_tree(dst['torch'], dst['jax'])
        assert os.path.exists(os.path.join(dst['torch'],
                                           'decoder_model.json'))


def test_cli_defaults_to_the_card(tmp_path):
    """Without --device the CLI loads on cuda, which raises without a
    card instead of falling back to the CPU."""
    src = native_dir(tmp_path / 'src', 'linear')
    code = ('import sys, torch\n'
            'torch.cuda.is_available = lambda: False\n'
            'from telluride_decoding_torch.cli import export_keras\n'
            'try:\n'
            '    export_keras.app_main(sys.argv[1:])\n'
            'except RuntimeError as error:\n'
            '    print("refused:", error)\n')
    proc = subprocess.run(
        [sys.executable, '-c', code, '--saved-model', src,
         str(tmp_path / 'out')], cwd=REPO, env=dict(os.environ,
                                                   PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=120)
    assert 'refused: No CUDA device is available' in proc.stdout, \
        proc.stdout
    assert not os.path.exists(tmp_path / 'out')
