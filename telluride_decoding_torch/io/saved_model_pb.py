"""TF-free writer of a SavedModel directory, the reference's native format.

Port of telluride_decoding_tpu/io/saved_model_pb.py. The reference saves
with ``model.save(saved_model_dir)`` and loads with
``tf.keras.models.load_model`` (reference decoding.py:571-576,
infer.py:264-282). io/keras_h5.py covers the HDF5 container; this module
writes the directory container (``saved_model.pb``, ``keras_metadata.pb``
and ``variables/``) by hand, byte for byte as the JAX writer does.

For Keras models whose metadata says ``must_restore_from_config: false``
the legacy tf_keras loader revives the model from the Keras config in
``keras_metadata.pb`` and restores the weights through the checkpoint's
own ``TrackableObjectGraph``; the traced functions, serving signatures
and saver of ``tf.saved_model.save`` are not read on that path. So a
loadable SavedModel needs four pieces, all plain wire formats:

  1. ``saved_model.pb``: SavedModel{MetaGraphDef{meta_info_def with
     tags=['serve'], a node-less GraphDef (versions only), and a
     SavedObjectGraph of user_object/variable nodes, no functions}}.
  2. ``keras_metadata.pb``: SavedMetadata with each node's Keras layer
     config, the stock-layer configs of the H5 exporter
     (io/keras_h5._GraphSpec), so loading needs no custom objects.
  3. ``variables/``: a TensorBundle (io/tf_checkpoint) holding the
     weights under ``layer_with_weights-<k>/<w>/.ATTRIBUTES/
     VARIABLE_VALUE`` keys and the serialized TrackableObjectGraph under
     ``_CHECKPOINTABLE_OBJECT_GRAPH``.
  4. ``assets/``: an empty directory.

The telluride metadata strings (telluride_metadata/_inputs/_output,
reference brain_model.py:255-280) ride as DT_STRING variables attached
to the root object, where reference-trained SavedModels carry them.

Protobuf field numbers follow the public schemas
(tensorflow/core/protobuf/{saved_model,meta_graph,saved_object_graph,
trackable_object_graph}.proto, tensorflow/python/keras/protobuf/
saved_metadata.proto), in the standard wire format (varint tags,
length-delimited submessages).

A CCA model written here has two dense kernels, so models/migrate.py
refuses it, as the JAX migrate refuses the JAX export; the linear model
reads back.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from telluride_decoding_torch.data.records import _write_varint
from telluride_decoding_torch.io.keras_h5 import _TELLURIDE, _build_spec
from telluride_decoding_torch.io.tf_checkpoint import write_tensor_bundle

_DT_FLOAT = 1
_DT_STRING = 7


# -- protobuf wire-format primitives ------------------------------------------

def _varint(value: int) -> bytes:
    out = bytearray()
    _write_varint(out, value)
    return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _vfield(field: int, value: int) -> bytes:
    """varint-typed field (int/bool/enum)."""
    return _tag(field, 0) + _varint(int(value))


def _bfield(field: int, payload: bytes) -> bytes:
    """length-delimited field (submessage/bytes)."""
    return _tag(field, 2) + _varint(len(payload)) + payload


def _sfield(field: int, text: str) -> bytes:
    return _bfield(field, text.encode('utf-8'))


def _version_def(producer: int, min_consumer: int = 1) -> bytes:
    """VersionDef: producer(1), min_consumer(2)."""
    return _vfield(1, producer) + _vfield(2, min_consumer)


def _shape_proto(shape: Sequence[int]) -> bytes:
    """TensorShapeProto: repeated Dim(2){size(1)}; scalar = no dims."""
    out = b''
    for dim in shape:
        out += _bfield(2, _vfield(1, int(dim)))
    return out


def _object_reference(node_id: int, local_name: str) -> bytes:
    """ObjectReference: node_id(1), local_name(2) — shared by
    SavedObject.children and TrackableObject.children."""
    return _vfield(1, node_id) + _sfield(2, local_name)


# -- object-graph model --------------------------------------------------------

class _Node:
    """One object-graph node, serialized into BOTH graphs: the
    SavedObjectGraph in saved_model.pb and the TrackableObjectGraph in
    the checkpoint (their node ids must correspond; the loader pairs
    the revived python object tree with the checkpoint graph by
    walking local_names)."""

    def __init__(self, identifier: Optional[str] = None,
                 version: int = 1,
                 variable: Optional[Dict] = None):
        self.identifier = identifier      # user_object kind when set
        self.version = version
        self.variable = variable          # {'dtype','shape','trainable','name'}
        self.children: List[Tuple[int, str]] = []
        # (full_name, checkpoint_key) for variables.
        self.attribute: Optional[Tuple[str, str]] = None

    def saved_object(self) -> bytes:
        out = b''
        for node_id, local in self.children:
            out += _bfield(1, _object_reference(node_id, local))
        if self.variable is not None:
            var = _vfield(1, self.variable['dtype'])
            var += _bfield(2, _shape_proto(self.variable['shape']))
            if self.variable.get('trainable'):
                var += _vfield(3, 1)
            var += _sfield(6, self.variable['name'])
            out += _bfield(7, var)
        else:
            user = _sfield(1, self.identifier)
            user += _bfield(2, _version_def(self.version))
            out += _bfield(4, user)
        return out

    def trackable_object(self) -> bytes:
        out = b''
        for node_id, local in self.children:
            out += _bfield(1, _object_reference(node_id, local))
        if self.attribute is not None:
            full_name, key = self.attribute
            tensor = (_sfield(1, 'VARIABLE_VALUE') +
                      _sfield(2, full_name) + _sfield(3, key))
            out += _bfield(2, tensor)
        return out


class _ObjectGraphs:
    def __init__(self):
        self.nodes: List[_Node] = []
        # keras_metadata rows: (node_id, node_path, identifier, json).
        self.metadata: List[Tuple[int, str, str, str]] = []
        # checkpoint_key -> array.
        self.tensors: Dict[str, np.ndarray] = {}

    def add(self, node: _Node) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    def add_list(self, refs: Sequence[int]) -> int:
        node = _Node('trackable_list_wrapper', version=1)
        node.children = [(r, str(i)) for i, r in enumerate(refs)]
        return self.add(node)


# -- keras metadata JSON -------------------------------------------------------

def _tuple_shape(shape: Sequence) -> Dict:
    return {'class_name': '__tuple__', 'items': list(shape)}


def _strip_keys(obj, keys=('module', 'registered_name')):
    """Recursively drops Keras-3-style serialization keys the legacy
    tf_keras metadata deserializer rejects (a failed from_config makes
    the loader silently fall back to an uncallable RevivedLayer; TF's
    own keras_metadata carries plain {class_name, config} dicts)."""
    if isinstance(obj, dict):
        return {k: _strip_keys(v) for k, v in obj.items()
                if k not in keys}
    if isinstance(obj, list):
        return [_strip_keys(v) for v in obj]
    return obj


def _metadata_config(layer: Dict) -> Dict:
    """Layer config for keras_metadata: batch_input_shape values are
    __tuple__-wrapped (keras json_utils encoding of python tuples) and
    Keras-3 serialization keys are stripped."""
    config = _strip_keys(dict(layer['config']))
    if 'batch_input_shape' in config and isinstance(
            config['batch_input_shape'], (list, tuple)):
        config['batch_input_shape'] = _tuple_shape(
            config['batch_input_shape'])
    return config


def _tensor_shape(width: int) -> Dict:
    return {'class_name': 'TensorShape', 'items': [None, int(width)]}


def _layer_input_shapes(spec) -> Dict[str, List[int]]:
    """Per-layer input widths, walked through the functional graph —
    the loader needs each weighted layer's build_input_shape to BUILD
    the revived layer before restoring weights (without it, revival
    silently falls back to an uncallable RevivedLayer)."""
    out_width: Dict[str, int] = {}
    in_widths: Dict[str, List[int]] = {}
    for layer in spec.layers:
        name = layer['name']
        class_name = layer['class_name']
        if class_name == 'InputLayer':
            out_width[name] = layer['config']['batch_input_shape'][1]
            continue
        inbound = [ref[0] for ref in layer['inbound_nodes'][0]]
        widths = [out_width[r] for r in inbound]
        in_widths[name] = widths
        if class_name == 'Dense':
            out_width[name] = layer['config']['units']
        elif class_name == 'Concatenate':
            out_width[name] = sum(widths)
        else:   # BatchNormalization, Activation: width-preserving.
            out_width[name] = widths[0]
    return in_widths


def _build_shape_entry(widths: Sequence[int]):
    if len(widths) == 1:
        return _tensor_shape(widths[0])
    return [_tensor_shape(w) for w in widths]


def _layer_metadata(layer: Dict, input_widths: Sequence[int]) -> Dict:
    config = _metadata_config(layer)
    if layer['class_name'] == 'InputLayer':
        return {'class_name': 'InputLayer',
                'name': config['name'],
                'dtype': config['dtype'],
                'sparse': config['sparse'],
                'ragged': config['ragged'],
                'batch_input_shape': config['batch_input_shape'],
                'config': config}
    return {'name': layer['name'], 'trainable': True,
            'expects_training_arg': False, 'dtype': 'float32',
            'batch_input_shape': None, 'stateful': False,
            'must_restore_from_config': False,
            'preserve_input_structure_in_config': False,
            'autocast': True, 'class_name': layer['class_name'],
            'config': config,
            'inbound_nodes': layer['inbound_nodes'],
            'build_input_shape': _build_shape_entry(input_widths)}


def _model_metadata(spec) -> Dict:
    model_config = {
        'name': spec.name, 'trainable': True,
        'layers': [dict(layer, config=_metadata_config(layer))
                   for layer in spec.layers],
        'input_layers': [[n, 0, 0] for n in spec.input_layers],
        'output_layers': [[spec.output_layer, 0, 0]]}
    input_widths = [
        layer['config']['batch_input_shape'][1]
        for layer in spec.layers if layer['class_name'] == 'InputLayer']
    return {'name': spec.name, 'trainable': True,
            'expects_training_arg': True, 'dtype': 'float32',
            'batch_input_shape': None,
            'must_restore_from_config': False,
            'preserve_input_structure_in_config': False,
            'autocast': False, 'class_name': 'Functional',
            'config': model_config, 'is_graph_network': True,
            'build_input_shape': _build_shape_entry(input_widths)}


# -- the object graphs and their bytes -----------------------------------------

def _weight_basename(qualified: str) -> str:
    """'dense/kernel:0' -> 'kernel'."""
    return qualified.split(':')[0].split('/')[-1]


def _build_graphs(spec, telluride: Dict[str, str]) -> _ObjectGraphs:
    g = _ObjectGraphs()
    input_widths = _layer_input_shapes(spec)
    root = g.add(_Node('_tf_keras_network', version=2))
    g.metadata.append((root, 'root', '_tf_keras_network',
                       json.dumps(_model_metadata(spec))))
    all_vars: List[int] = []
    train_vars: List[int] = []
    weighted = 0
    for i, layer in enumerate(spec.layers):
        weights = spec.weights.get(layer['name'], [])
        if layer['class_name'] == 'InputLayer':
            lid = g.add(_Node('_tf_keras_input_layer', version=2))
            g.nodes[root].children.append((lid, 'layer-%d' % i))
            path = 'root.layer-%d' % i
        else:
            lid = g.add(_Node('_tf_keras_layer', version=2))
            if weights:
                g.nodes[root].children.append(
                    (lid, 'layer_with_weights-%d' % weighted))
                path = 'root.layer_with_weights-%d' % weighted
            else:
                path = 'root.layer-%d' % i
            g.nodes[root].children.append((lid, 'layer-%d' % i))
        g.metadata.append((lid, path, g.nodes[lid].identifier,
                           json.dumps(_layer_metadata(
                               layer,
                               input_widths.get(layer['name'], ())))))
        layer_vars: List[int] = []
        layer_train: List[int] = []
        for qualified, arr in weights:
            wname = _weight_basename(qualified)
            trainable = wname not in ('moving_mean', 'moving_variance')
            vid = g.add(_Node(variable={
                'dtype': _DT_FLOAT, 'shape': arr.shape,
                'trainable': trainable,
                'name': '%s/%s' % (layer['name'], wname)}))
            key = ('layer_with_weights-%d/%s/.ATTRIBUTES/VARIABLE_VALUE'
                   % (weighted, wname))
            g.nodes[vid].attribute = ('%s/%s' % (layer['name'], wname),
                                      key)
            g.tensors[key] = arr
            g.nodes[lid].children.append((vid, wname))
            layer_vars.append(vid)
            all_vars.append(vid)
            if trainable:
                layer_train.append(vid)
                train_vars.append(vid)
        if weights:
            weighted += 1
            g.nodes[lid].children.append(
                (g.add_list(layer_vars), 'variables'))
            g.nodes[lid].children.append(
                (g.add_list(layer_train), 'trainable_variables'))
    g.nodes[root].children.append((g.add_list(all_vars), 'variables'))
    g.nodes[root].children.append(
        (g.add_list(train_vars), 'trainable_variables'))
    for attr, value in telluride.items():
        vid = g.add(_Node(variable={
            'dtype': _DT_STRING, 'shape': (), 'trainable': False,
            'name': attr}))
        key = '%s/.ATTRIBUTES/VARIABLE_VALUE' % attr
        g.nodes[vid].attribute = (attr, key)
        g.tensors[key] = np.array(value.encode('utf-8'), dtype=object)
        g.nodes[root].children.append((vid, attr))
    return g


def _saved_model_bytes(g: _ObjectGraphs) -> bytes:
    meta_info = (_sfield(4, 'serve') + _sfield(5, '2.15.0') +
                 _sfield(6, 'unknown'))
    # A node-less GraphDef; versions chosen inside TF 2.x's accepted
    # producer range (the loader only checks compatibility bounds).
    graph_def = _bfield(4, _version_def(1882, 12))
    object_graph = b''.join(_bfield(1, n.saved_object())
                            for n in g.nodes)
    meta_graph = (_bfield(1, meta_info) + _bfield(2, graph_def) +
                  _bfield(7, object_graph))
    return _vfield(1, 1) + _bfield(2, meta_graph)


def _keras_metadata_bytes(g: _ObjectGraphs) -> bytes:
    out = b''
    for node_id, path, identifier, metadata in g.metadata:
        node = (_vfield(2, node_id) + _sfield(3, path) +
                _sfield(4, identifier) + _sfield(5, metadata) +
                _bfield(6, _version_def(2)))
        out += _bfield(1, node)
    return out


def _trackable_graph_bytes(g: _ObjectGraphs) -> bytes:
    return b''.join(_bfield(1, n.trackable_object()) for n in g.nodes)


def export_saved_model(model, out_dir: str) -> None:
    """Writes ``model`` as a SavedModel directory that
    ``tf.keras.models.load_model`` (legacy tf_keras) loads with no
    custom objects, without TensorFlow. The linear and CCA families
    export."""
    if model.params is None:
        raise ValueError('Model must be fit or loaded before export.')
    spec = _build_spec(model)
    telluride = {}
    for attr in _TELLURIDE:
        value = getattr(model, attr, None)
        if value:
            telluride[attr] = value
    g = _build_graphs(spec, telluride)
    os.makedirs(os.path.join(out_dir, 'variables'), exist_ok=True)
    os.makedirs(os.path.join(out_dir, 'assets'), exist_ok=True)
    with open(os.path.join(out_dir, 'saved_model.pb'), 'wb') as f:
        f.write(_saved_model_bytes(g))
    with open(os.path.join(out_dir, 'keras_metadata.pb'), 'wb') as f:
        f.write(_keras_metadata_bytes(g))
    tensors = dict(g.tensors)
    tensors['_CHECKPOINTABLE_OBJECT_GRAPH'] = np.array(
        _trackable_graph_bytes(g), dtype=object)
    write_tensor_bundle(
        os.path.join(out_dir, 'variables', 'variables'), tensors)
