"""Migrates reference (TF SavedModel) models into the port.

Port of telluride_decoding_tpu/models/migrate.py. The reference serves
Keras SavedModels with its experiment metadata in tf.Variables
(reference brain_model.py:255-280). load_reference_saved_model reads
such a model without TensorFlow (weights and metadata straight out of
the checkpoint bundle, io.tf_checkpoint) and builds the port's model on
a device:

    model = load_reference_saved_model('/path/to/saved_model_dir',
                                       device='cuda')
    model.save('/path/to/native_model')   # model.json + weights.npz.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

import numpy as np

from telluride_decoding_torch.io.tf_checkpoint import read_tensor_bundle
from telluride_decoding_torch.models.brain_model import BrainModel
from telluride_decoding_torch.models.convert import (
    cca_params_from_numpy, linear_params_from_numpy)


def _find(tensors: Dict[str, np.ndarray], substrings) -> Optional[str]:
    for key in sorted(tensors):
        if all(s in key for s in substrings):
            return key
    return None


def load_reference_saved_model(saved_model_dir: str, *,
                               device) -> BrainModel:
    """The port's model, on ``device``, of a reference SavedModel
    directory.

    Reads the deterministic families (linear regression and CCA); the
    embedded telluride metadata strings are kept verbatim on the
    returned model, except metadata that is not valid JSON, which is
    dropped.
    """
    prefix = os.path.join(saved_model_dir, 'variables', 'variables')
    if not os.path.exists(prefix + '.index'):
        raise IOError('No checkpoint found under %s.' % saved_model_dir)
    tensors = read_tensor_bundle(prefix)

    def string_var(name) -> Optional[str]:
        key = _find(tensors, [name])
        if key is None:
            return None
        return tensors[key].reshape(-1)[0].decode('utf-8')

    metadata = string_var('telluride_metadata')
    inputs = string_var('telluride_inputs')
    output = string_var('telluride_output')

    # The embedded flags JSON names the family. Shapes alone cannot tell
    # a classifier without hidden layers (one Dense + sigmoid over
    # concat(input_1, input_2), reference decoding.py:291-295) from a
    # linear regression, so SGD families are refused up front.
    family = None
    if metadata:
        try:
            family = json.loads(metadata).get('dnn_regressor')
        except ValueError:
            pass
    if family not in (None, 'linear', 'linear_with_bias', 'cca'):
        raise ValueError(
            'Reference SavedModel records dnn_regressor=%r in its '
            'telluride metadata. Only the deterministic families '
            '(linear regression, CCA) migrate; retrain DNN/classifier '
            'models natively with cli.decoding.' % family)

    kernel_key = _find(tensors, ['kernel'])
    rot1_key = _find(tensors, ['rot1'])
    if kernel_key is None and rot1_key is None:
        # tf_keras checkpoints a subclassed model positionally: its
        # weights are variables/<n> in creation order, with no layer
        # names. The family is told by the shapes:
        #   linear: [(Din, Dout) kernel, (Dout,) bias]
        #   CCA:    [(1, D1) mean1, (1, D2) mean2,
        #            (D1, k) rot1, (D2, k) rot2]   (build order,
        #            reference cca.py:130-146)
        positional = []
        for key in tensors:
            m = re.match(r'variables/(\d+)/', key)
            if m and tensors[key].dtype != object:
                positional.append((int(m.group(1)), tensors[key]))
        arrays = [a for _, a in sorted(positional, key=lambda p: p[0])]
        shapes = [a.shape for a in arrays]
        if (len(arrays) == 2 and len(shapes[0]) == 2 and
                shapes[1] == (shapes[0][1],)):
            tensors = dict(tensors, **{'dense/kernel': arrays[0],
                                       'dense/bias': arrays[1]})
            kernel_key = 'dense/kernel'
        elif (len(arrays) == 4 and
              all(len(s) == 2 for s in shapes) and
              shapes[0][0] == 1 and shapes[1][0] == 1 and
              shapes[2] == (shapes[0][1], shapes[2][1]) and
              shapes[3] == (shapes[1][1], shapes[2][1])):
            tensors = dict(tensors, **{'cca/mean1': arrays[0],
                                       'cca/mean2': arrays[1],
                                       'cca/rot1': arrays[2],
                                       'cca/rot2': arrays[3]})
            rot1_key = 'cca/rot1'
    if rot1_key is not None:
        mean1 = tensors[_find(tensors, ['mean1'])].astype(np.float32)
        mean2 = tensors[_find(tensors, ['mean2'])].astype(np.float32)
        rot1 = tensors[rot1_key].astype(np.float32)
        rot2 = tensors[_find(tensors, ['rot2'])].astype(np.float32)
        model = cca_params_from_numpy(
            {'mean1': mean1.reshape(1, -1), 'mean2': mean2.reshape(1, -1),
             'rot1': rot1, 'rot2': rot2}, device,
            {'cca_dims': rot1.shape[1], 'regularization_lambda': 0.0,
             'input1_width': rot1.shape[0], 'input2_width': rot2.shape[0]})
    elif kernel_key is not None:
        # Exactly one dense kernel is the linear model. More kernels are
        # a DNN or classifier: a linear model from whichever kernel sorts
        # first would serve wrong predictions, so refuse.
        kernels = [k for k in tensors
                   if 'kernel' in k and 'OPTIMIZER_SLOT' not in k]
        if len(kernels) > 1:
            raise ValueError(
                'Reference SavedModel has %d dense kernels (%s) — a '
                'DNN/classifier model. Only the deterministic families '
                '(linear regression, CCA) migrate; retrain DNNs '
                'natively with cli.decoding.' %
                (len(kernels), sorted(kernels)))
        kernel = tensors[kernel_key].astype(np.float32)
        bias_key = _find(tensors, ['bias'])
        bias = (tensors[bias_key].astype(np.float32).reshape(-1)
                if bias_key else np.zeros((kernel.shape[1],), np.float32))
        model = linear_params_from_numpy(
            {'w': kernel, 'b': bias}, device,
            {'regularization_lambda': 0.0, 'input_width': kernel.shape[0],
             'output_width': kernel.shape[1]})
    else:
        raise ValueError(
            'Unrecognized reference model: no kernel or CCA rotations '
            'among %s' % sorted(tensors))

    model.telluride_metadata = metadata
    model.telluride_inputs = inputs
    model.telluride_output = output
    if metadata:
        try:
            json.loads(metadata)
        except ValueError:
            model.telluride_metadata = None
    return model
