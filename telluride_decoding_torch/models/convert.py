"""Carries weights of the JAX package across to the port.

The JAX package saves a model's params pytree flattened into
``weights.npz``, keyed by ``_flat_key`` (telluride_decoding_tpu/models/
brain_model.py:66): mean1, mean2, rot1 and rot2 for the CCA model, w and
b for the linear regression, ``layers/0/w``, ``bn/0/gamma``, ``0/w`` or
``tower1/0/w`` and so on for the SGD families. The port reads and writes
the same file, so this is the one place that turns such a flat dict (or
the nested pytree itself) into the port's module.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from telluride_decoding_torch.models.brain_model import (
    BrainModelLinearRegression)
from telluride_decoding_torch.models.cca import BrainModelCCA


def cca_params_from_numpy(flat: Dict[str, np.ndarray], device,
                          config: Optional[dict] = None) -> BrainModelCCA:
    """BrainModelCCA on ``device`` holding the flat dict's weights.

    ``config`` is the model.json constructor config; without one it is
    read off the weight shapes.
    """
    if config is None:
        rot1 = np.asarray(flat['rot1'])
        config = {'cca_dims': int(rot1.shape[1]),
                  'regularization_lambda': 0.0,
                  'input1_width': int(rot1.shape[0]),
                  'input2_width': int(np.asarray(flat['rot2']).shape[0])}
    model = BrainModelCCA(**config, device=device)
    model._restore_params(flat)
    if flat:
        widths = (model.rot1.shape[0], model.rot2.shape[0])
        if (model.mean1.shape != (1, widths[0]) or
                model.mean2.shape != (1, widths[1]) or
                model.rot1.shape[1] != model.rot2.shape[1]):
            raise ValueError('Inconsistent CCA weights: %s.'
                             % {k: tuple(np.shape(v))
                                for k, v in flat.items()})
    return model


def linear_params_from_numpy(flat: Dict[str, np.ndarray], device,
                             config: Optional[dict] = None
                             ) -> BrainModelLinearRegression:
    """BrainModelLinearRegression on ``device`` holding the flat dict's
    weights (w [Dx, Dy], b [Dy]); without ``config`` the widths are read
    off w."""
    if config is None:
        w = np.asarray(flat['w'])
        config = {'regularization_lambda': 0.0,
                  'input_width': int(w.shape[0]),
                  'output_width': int(w.shape[1])}
    model = BrainModelLinearRegression(**config, device=device)
    model._restore_params(flat)
    if flat and (model.w.dim() != 2 or
                 tuple(model.b.shape) != (model.w.shape[1],)):
        raise ValueError('Inconsistent linear weights: %s.'
                         % {k: tuple(np.shape(v)) for k, v in flat.items()})
    return model


def flat_params(tree: Any, prefix: str = '') -> Dict[str, np.ndarray]:
    """A params pytree of dicts and lists with array leaves, flattened
    under the JAX package's ``_flat_key`` names: dict keys sorted, list
    items by index, joined with '/'."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree, np.float32)}
    flat = {}
    for key, value in items:
        flat.update(flat_params(value, '%s%s/' % (prefix, key)))
    return flat


def sgd_params_from_numpy(model_class: str, params, device,
                          config: dict):
    """The SGD model ``model_class`` (BrainModelDNN,
    BrainModelClassifier or BrainModelDCCA) of constructor ``config`` on
    ``device``, holding ``params``: a flat weights.npz dict or the JAX
    params pytree with numpy leaves. A DNN checkpoint from before batch
    norm (``0/w`` for ``layers/0/w``) loads too."""
    from telluride_decoding_torch.models.brain_model import (
        BrainModelClassifier, BrainModelDNN)
    from telluride_decoding_torch.models.cca import BrainModelDCCA
    cls = {c.__name__: c for c in (BrainModelDNN, BrainModelClassifier,
                                   BrainModelDCCA)}[model_class]
    model = cls(**config, device=device)
    params = flat_params(params)
    model._restore_params(params)
    if params:
        got = {k: tuple(v.shape) for k, v in model.params.items()}
        want = dict(model.param_shapes())
        if got != want:
            raise ValueError('Weights of shapes %s do not fit a %s of config '
                             '%s.' % (got, model_class, config))
    return model
