"""Exports trained models as Keras-loadable HDF5 files, without TensorFlow.

Port of telluride_decoding_tpu/io/keras_h5.py. The reference saves with ``model.save(saved_model_dir)`` and
loads through ``tf.keras.models.load_model`` (reference
decoding.py:571-576, infer_decoder.py:250-286), which also takes a Keras
HDF5 file. This module writes that file by hand (h5py + JSON), as a
functional graph of stock layers, so a model loads with no custom
objects:

  * linear:  input_1 -> Dense(out)                          (exact)
  * CCA:     Dense(rot1, bias=-mean1 @ rot1)(input_1) ++
             Dense(rot2, bias=-mean2 @ rot2)(input_2)       (exact:
             (x - mean) @ rot == x @ rot - mean @ rot)
  * DNN:     input_1 -> Dense(relu) ... -> Dense(linear); with batch
             norm, Dense(linear) -> BatchNormalization -> Activation(relu)
  * classifier: Concatenate(input_1, input_2) -> Dense(relu) ... ->
             Dense(sigmoid)
  * DCCA:    each tower's Dense(relu) stack with a linear last layer, then
             the final CCA folded into one more Dense, as for CCA; the
             towers interleaved level by level; Concatenate

The graphs take the reference serving feed ({'input_1', 'input_2'};
input_2 stays in the graph where a family ignores it).

Every weight is written from numpy float32 read off the model's buffers
(on the card or not), and the CCA's folded bias is computed in numpy
float32, so the bytes are the JAX exporter's for the same weights.

export_saved_model_variables writes a reference-style ``variables/``
TensorBundle (io.tf_checkpoint) for restoring weights into a reference
model object. h5py is imported only by export_keras_h5.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from telluride_decoding_torch.io.tf_checkpoint import write_tensor_bundle

# Version stamps: the format is what the loader reads; these identify
# the writer. tf_keras accepts any 2.x keras_version.
_KERAS_VERSION = '2.15.0'
_BACKEND = 'tensorflow'
_TELLURIDE = ('telluride_metadata', 'telluride_inputs', 'telluride_output')


def _float32(value) -> np.ndarray:
    """A model buffer (a tensor on any device) as a numpy float32 array."""
    return np.asarray(value.cpu().numpy(), np.float32)


def _input_layer(name: str, width: int) -> Dict:
    return {'class_name': 'InputLayer',
            'config': {'batch_input_shape': [None, int(width)],
                       'dtype': 'float32', 'sparse': False,
                       'ragged': False, 'name': name,
                       'optional': False},
            'name': name, 'inbound_nodes': []}


def _dense_layer(name: str, units: int, activation: str,
                 inbound: str, use_bias: bool = True) -> Dict:
    return {'class_name': 'Dense',
            'config': {'name': name, 'trainable': True,
                       'dtype': 'float32', 'units': int(units),
                       'activation': activation, 'use_bias': use_bias,
                       'kernel_initializer': {
                           'module': 'keras.initializers',
                           'class_name': 'GlorotUniform',
                           'config': {'seed': None},
                           'registered_name': None},
                       'bias_initializer': {
                           'module': 'keras.initializers',
                           'class_name': 'Zeros', 'config': {},
                           'registered_name': None},
                       'kernel_regularizer': None,
                       'bias_regularizer': None,
                       'activity_regularizer': None,
                       'kernel_constraint': None,
                       'bias_constraint': None},
            'name': name,
            'inbound_nodes': [[[inbound, 0, 0, {}]]]}


def _batchnorm_layer(name: str, inbound: str,
                     epsilon: float = 1e-5) -> Dict:
    return {'class_name': 'BatchNormalization',
            'config': {'name': name, 'trainable': True,
                       'dtype': 'float32', 'axis': [1],
                       'momentum': 0.99, 'epsilon': epsilon,
                       'center': True, 'scale': True,
                       'beta_initializer': {
                           'module': 'keras.initializers',
                           'class_name': 'Zeros', 'config': {},
                           'registered_name': None},
                       'gamma_initializer': {
                           'module': 'keras.initializers',
                           'class_name': 'Ones', 'config': {},
                           'registered_name': None},
                       'moving_mean_initializer': {
                           'module': 'keras.initializers',
                           'class_name': 'Zeros', 'config': {},
                           'registered_name': None},
                       'moving_variance_initializer': {
                           'module': 'keras.initializers',
                           'class_name': 'Ones', 'config': {},
                           'registered_name': None},
                       'beta_regularizer': None,
                       'gamma_regularizer': None,
                       'beta_constraint': None,
                       'gamma_constraint': None},
            'name': name,
            'inbound_nodes': [[[inbound, 0, 0, {}]]]}


def _concat_layer(name: str, inbounds: Sequence[str]) -> Dict:
    return {'class_name': 'Concatenate',
            'config': {'name': name, 'trainable': True,
                       'dtype': 'float32', 'axis': -1},
            'name': name,
            'inbound_nodes': [[[n, 0, 0, {}] for n in inbounds]]}


class _GraphSpec:
    """A functional-model description: layer configs + weights."""

    def __init__(self, name: str):
        self.name = name
        self.layers: List[Dict] = []
        # layer name -> [(weight_name, array), ...]
        self.weights: Dict[str, List] = {}
        self.input_layers: List[str] = []
        self.output_layer: Optional[str] = None

    def add_input(self, name: str, width: int):
        self.layers.append(_input_layer(name, width))
        self.weights[name] = []
        self.input_layers.append(name)

    def add_layer(self, config: Dict, weights: Sequence = ()):
        self.layers.append(config)
        name = config['name']
        self.weights[name] = [
            ('%s/%s:0' % (name, wname), np.asarray(arr, np.float32))
            for wname, arr in weights]

    def model_config(self) -> Dict:
        return {'class_name': 'Functional',
                'config': {
                    'name': self.name, 'trainable': True,
                    'layers': self.layers,
                    'input_layers': [[n, 0, 0]
                                     for n in self.input_layers],
                    'output_layers': [[self.output_layer, 0, 0]]}}


def _spec_linear(model) -> _GraphSpec:
    w = _float32(model.params['w'])
    b = _float32(model.params['b']).reshape(-1)
    spec = _GraphSpec('model')
    spec.add_input('input_1', w.shape[0])
    spec.add_input('input_2', 1)
    spec.add_layer(_dense_layer('dense', w.shape[1], 'linear',
                                'input_1'),
                   [('kernel', w), ('bias', b)])
    spec.output_layer = 'dense'
    return spec


def _spec_cca(model) -> _GraphSpec:
    p = model.params
    rot1 = _float32(p['rot1'])
    rot2 = _float32(p['rot2'])
    mean1 = _float32(p['mean1']).reshape(-1)
    mean2 = _float32(p['mean2']).reshape(-1)
    spec = _GraphSpec('model')
    spec.add_input('input_1', rot1.shape[0])
    spec.add_input('input_2', rot2.shape[0])
    # (x - mean) @ rot == x @ rot + (-mean @ rot): stock Dense.
    spec.add_layer(_dense_layer('rot1', rot1.shape[1], 'linear',
                                'input_1'),
                   [('kernel', rot1), ('bias', -mean1 @ rot1)])
    spec.add_layer(_dense_layer('rot2', rot2.shape[1], 'linear',
                                'input_2'),
                   [('kernel', rot2), ('bias', -mean2 @ rot2)])
    spec.add_layer(_concat_layer('concatenate', ['rot1', 'rot2']))
    spec.output_layer = 'concatenate'
    return spec


def _layer_count(params, prefix: str = '') -> int:
    """Dense layers of a stack whose weights are ``{prefix}{i}/w``."""
    count = 0
    while '%s%d/w' % (prefix, count) in params:
        count += 1
    return count


def _spec_dcca(model) -> _GraphSpec:
    """Each tower a ReLU Dense stack with a linear last Dense, then the
    final CCA ``(h - mean) @ rot`` folded into one more Dense, as in
    _spec_cca; Concatenate joins the canonical outputs."""
    p = model.params
    spec = _GraphSpec('model')
    spec.add_input('input_1', p['tower1/0/w'].shape[0])
    spec.add_input('input_2', p['tower2/0/w'].shape[0])

    def tower(index):
        """[(config, weights)] of one tower, ending in the folded CCA."""
        out = []
        prev = 'input_%d' % index
        n = _layer_count(p, 'tower%d/' % index)
        for i in range(n):
            w = _float32(p['tower%d/%d/w' % (index, i)])
            b = _float32(p['tower%d/%d/b' % (index, i)]).reshape(-1)
            name = 'dense_t%d_%d' % (index, i)
            out.append((_dense_layer(name, w.shape[1],
                                     'linear' if i == n - 1 else 'relu',
                                     prev),
                        [('kernel', w), ('bias', b)]))
            prev = name
        rot = _float32(p['rot%d' % index])
        mean = _float32(p['mean%d' % index]).reshape(-1)
        out.append((_dense_layer('rot%d' % index, rot.shape[1], 'linear',
                                 prev),
                    [('kernel', rot), ('bias', -mean @ rot)]))
        return out

    # Keras's topological (depth) order: the towers interleaved level by
    # level, as the legacy loader numbers layer_with_weights-<k>.
    for (c1, w1), (c2, w2) in zip(tower(1), tower(2)):
        spec.add_layer(c1, w1)
        spec.add_layer(c2, w2)
    spec.add_layer(_concat_layer('concatenate', ['rot1', 'rot2']))
    spec.output_layer = 'concatenate'
    return spec


def _spec_dnn(model) -> _GraphSpec:
    p = model.params
    n_layers = _layer_count(p, 'layers/')
    batch_norm = 'bn/0/gamma' in p
    spec = _GraphSpec('model')
    spec.add_input('input_1', p['layers/0/w'].shape[0])
    spec.add_input('input_2', 1)
    prev = 'input_1'
    for i in range(n_layers):
        w = _float32(p['layers/%d/w' % i])
        b = _float32(p['layers/%d/b' % i]).reshape(-1)
        last = i == n_layers - 1
        name = 'dense_%d' % i
        if batch_norm and not last:
            # dense -> batch norm -> relu: the Dense stays linear and the
            # relu gets an Activation layer of its own.
            spec.add_layer(_dense_layer(name, w.shape[1], 'linear', prev),
                           [('kernel', w), ('bias', b)])
            bn_name = 'batch_normalization_%d' % i
            spec.add_layer(
                _batchnorm_layer(bn_name, name),
                [(keras_name, _float32(p['bn/%d/%s' % (i, ours)]))
                 for keras_name, ours in (('gamma', 'gamma'),
                                          ('beta', 'beta'),
                                          ('moving_mean', 'mean'),
                                          ('moving_variance', 'var'))])
            act_name = 'activation_%d' % i
            spec.add_layer({'class_name': 'Activation',
                            'config': {'name': act_name, 'trainable': True,
                                       'dtype': 'float32',
                                       'activation': 'relu'},
                            'name': act_name,
                            'inbound_nodes': [[[bn_name, 0, 0, {}]]]})
            prev = act_name
        else:
            spec.add_layer(_dense_layer(name, w.shape[1],
                                        'linear' if last else 'relu', prev),
                           [('kernel', w), ('bias', b)])
            prev = name
    spec.output_layer = prev
    return spec


def _spec_classifier(model) -> _GraphSpec:
    p = model.params
    in2 = model._input2_width
    spec = _GraphSpec('model')
    spec.add_input('input_1', p['0/w'].shape[0] - in2)
    spec.add_input('input_2', in2)
    spec.add_layer(_concat_layer('concatenate', ['input_1', 'input_2']))
    prev = 'concatenate'
    n_layers = _layer_count(p)
    for i in range(n_layers):
        w = _float32(p['%d/w' % i])
        b = _float32(p['%d/b' % i]).reshape(-1)
        name = 'dense_%d' % i
        spec.add_layer(_dense_layer(name, w.shape[1],
                                    'sigmoid' if i == n_layers - 1
                                    else 'relu', prev),
                       [('kernel', w), ('bias', b)])
        prev = name
    spec.output_layer = prev
    return spec


def _build_spec(model) -> _GraphSpec:
    kind = type(model).__name__
    specs = {'BrainModelLinearRegression': _spec_linear,
             'BrainModelCCA': _spec_cca, 'BrainModelDCCA': _spec_dcca,
             'BrainModelDNN': _spec_dnn,
             'BrainModelClassifier': _spec_classifier}
    if kind not in specs:
        raise ValueError('No Keras H5 export for model type %s.' % kind)
    return specs[kind](model)


def export_keras_h5(model, path: str) -> None:
    """Writes ``model`` as a Keras HDF5 file that
    ``tf.keras.models.load_model`` (legacy tf_keras) loads with no custom
    objects, and its telluride strings to a ``.telluride.json`` sidecar.
    Every persistable family exports (linear, CCA, DNN, classifier,
    DCCA). Needs h5py."""
    try:
        import h5py
    except ImportError as error:
        raise ImportError('export_keras_h5 needs h5py, which is not '
                          'installed; export a SavedModel directory '
                          '(export_saved_model) instead.') from error
    if model.params is None:
        raise ValueError('Model must be fit or loaded before export.')
    spec = _build_spec(model)
    with h5py.File(path, 'w') as f:
        f.attrs['keras_version'] = _KERAS_VERSION
        f.attrs['backend'] = _BACKEND
        f.attrs['model_config'] = json.dumps(spec.model_config())
        mw = f.create_group('model_weights')
        str_dt = h5py.string_dtype(encoding='utf-8')
        mw.attrs.create('layer_names',
                        [l['name'] for l in spec.layers] +
                        ['top_level_model_weights'], dtype=str_dt)
        mw.attrs['backend'] = _BACKEND
        mw.attrs['keras_version'] = _KERAS_VERSION
        for layer in spec.layers:
            name = layer['name']
            g = mw.create_group(name)
            weights = spec.weights.get(name, [])
            g.attrs.create('weight_names',
                           [wn for wn, _ in weights], dtype=str_dt)
            for wn, arr in weights:
                g.create_dataset(wn, data=arr)
        g = mw.create_group('top_level_model_weights')
        g.attrs.create('weight_names', [], dtype=str_dt)
    # HDF5 carries config + weights only; the reference's Decoder also
    # reads the telluride_{metadata,inputs,output} variables off the
    # model object (reference infer_decoder.py:278-286), so they ship as
    # a sidecar, written when any of the three is set (as the SavedModel
    # exporter keeps each on its own).
    if any(getattr(model, attr, None) for attr in _TELLURIDE):
        sidecar = {attr: getattr(model, attr, None) or ''
                   for attr in _TELLURIDE}
        base = path[:-3] if path.endswith('.h5') else path
        with open(base + '.telluride.json', 'w') as f:
            json.dump(sidecar, f, indent=1)


def export_saved_model_variables(model, variables_dir: str) -> None:
    """Writes a reference-style ``variables/`` checkpoint directory
    (TensorBundle, the binary format inside every SavedModel) holding
    this model's weights under the names a freshly built reference model
    checkpoints them as (positional ``variables/<n>``), and the
    telluride metadata strings. A reference-side user restores with
    ``model.load_weights(dir + '/variables')`` on a built model of the
    same architecture."""
    kind = type(model).__name__
    if kind == 'BrainModelLinearRegression':
        arrays = [_float32(model.params['w']), _float32(model.params['b'])]
    elif kind == 'BrainModelCCA':
        p = model.params
        arrays = [_float32(p['mean1']), _float32(p['mean2']),
                  _float32(p['rot1']), _float32(p['rot2'])]
    else:
        raise ValueError(
            'Reference variables export covers the deterministic '
            'families (linear, CCA); %s has no fixed reference '
            'variable order.' % kind)
    tensors = {}
    for i, arr in enumerate(arrays):
        tensors['variables/%d/.ATTRIBUTES/VARIABLE_VALUE' % i] = arr
    for attr in _TELLURIDE:
        value = getattr(model, attr, None)
        if value:
            tensors['%s/.ATTRIBUTES/VARIABLE_VALUE' % attr] = (
                np.array(value.encode('utf-8'), dtype=object))
    os.makedirs(variables_dir, exist_ok=True)
    write_tensor_bundle(os.path.join(variables_dir, 'variables'),
                        tensors)
