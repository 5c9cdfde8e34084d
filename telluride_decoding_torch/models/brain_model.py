"""Brain model base (port of models/brain_model.py:66-356).

A model is an ``nn.Module`` whose parameters are buffers (the fits are
deterministic, no gradient). ``save``/``load_model`` read and write the
JAX package's directory format: ``model.json`` (class name, constructor
config, telluride metadata) and ``weights.npz`` keyed as its
``_flat_key`` keys a params dict, so a model directory written by either
package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from telluride_decoding_torch import device as device_policy
from telluride_decoding_torch.ops import pearson


def dataset_arrays(dataset) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(input_1, input_2, output) arrays of an iterable of
    (input_dict, output) minibatches, concatenated."""
    xs, x2s, ys = [], [], []
    for inputs, y in dataset:
        xs.append(np.asarray(inputs['input_1']))
        x2s.append(np.asarray(inputs['input_2']))
        ys.append(np.asarray(y))
    if not xs:
        raise ValueError('Dataset produced no batches.')
    return np.concatenate(xs), np.concatenate(x2s), np.concatenate(ys)


_MODEL_REGISTRY: Dict[str, type] = {}


def register_model(cls):
    _MODEL_REGISTRY[cls.__name__] = cls
    return cls


class BrainModel(torch.nn.Module):
    """Base model: buffers + forward + metrics + save.

    Subclasses name their buffers in ``param_names`` and implement
    ``forward(input_dict)``, ``config()`` and ``from_numpy``.
    """

    loss_name = 'mse'
    metric_names: Sequence[str] = ('pearson_correlation_first',)
    param_names: Sequence[str] = ()

    def __init__(self, device):
        super().__init__()
        self.device = device_policy.resolve(device)
        for name in self.param_names:
            self.register_buffer(name, None)
        # Bumped by every fit or restore, so decoders that cache
        # parameter-derived tensors can tell a refit.
        self.params_version = 0
        self.telluride_metadata: Optional[str] = None
        self.telluride_inputs: Optional[str] = None
        self.telluride_output: Optional[str] = None

    @property
    def params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The parameter buffers by name; None before a fit or load."""
        values = {name: getattr(self, name) for name in self.param_names}
        if any(v is None for v in values.values()):
            return None
        return values

    def set_params(self, values: Dict[str, torch.Tensor]):
        for name in self.param_names:
            setattr(self, name, values[name].to(self.device, torch.float32))
        self.params_version += 1

    def config(self) -> Dict[str, Any]:
        """JSON-serializable constructor config for save/load."""
        raise NotImplementedError

    def as_tensor(self, value) -> torch.Tensor:
        """A model input on this model's device (float stays float)."""
        value = device_policy.as_tensor(value, self.device)
        return value if value.is_floating_point() else value.float()

    def predict(self, dataset) -> np.ndarray:
        in1, in2, _ = dataset_arrays(dataset)
        return self({'input_1': in1, 'input_2': in2}).cpu().numpy()

    # -- metrics -------------------------------------------------------------

    def _metric(self, name: str, y_true: torch.Tensor,
                y_pred: torch.Tensor) -> torch.Tensor:
        if name in ('mse', 'loss_mse'):
            return torch.mean(torch.square(y_true - y_pred))
        if name == 'pearson_correlation_first':
            return pearson.pearson_correlation_first(y_true, y_pred)
        if name == 'cca_pearson_correlation_first':
            half = y_pred.shape[-1] // 2
            return pearson.pearson_correlation_first(y_pred[:, :half],
                                                     y_pred[:, half:])
        raise ValueError('Unknown metric %s' % name)

    def evaluate(self, dataset) -> Dict[str, float]:
        """Loss and metrics over the whole dataset, as one split."""
        in1, in2, out = dataset_arrays(dataset)
        with torch.no_grad():
            y_pred = self({'input_1': in1, 'input_2': in2})
            y_true = self.as_tensor(out)
            results = {'loss': self._metric(self.loss_name, y_true, y_pred)}
            for name in self.metric_names:
                results[name] = self._metric(name, y_true, y_pred)
        return {k: float(v) for k, v in results.items()}

    # -- metadata ------------------------------------------------------------

    def add_metadata(self, flags):
        """Stores the experiment flags (lag contexts etc.) with the model."""
        self.telluride_metadata = json.dumps(flags)

    # -- persistence ----------------------------------------------------------

    def save(self, model_dir: str):
        """Saves config + metadata (model.json) and weights (weights.npz)."""
        os.makedirs(model_dir, exist_ok=True)
        params = self.params or {}
        np.savez(os.path.join(model_dir, 'weights.npz'),
                 **{k: v.cpu().numpy() for k, v in params.items()})
        meta = {
            'model_class': type(self).__name__,
            'config': self.config(),
            'telluride_metadata': self.telluride_metadata,
            'telluride_inputs': self.telluride_inputs,
            'telluride_output': self.telluride_output,
        }
        with open(os.path.join(model_dir, 'model.json'), 'w') as f:
            json.dump(meta, f, indent=2)

    def _restore_params(self, flat: Dict[str, np.ndarray]):
        """Sets the buffers from the flattened weights.npz dict."""
        if not flat:
            for name in self.param_names:
                setattr(self, name, None)
            self.params_version += 1
            return
        missing = [k for k in self.param_names if k not in flat]
        if missing:
            raise ValueError(
                'Checkpoint is missing weight %r (has %s); was it saved by '
                'an incompatible model config?' % (missing[0], sorted(flat)))
        self.set_params({k: torch.as_tensor(np.asarray(flat[k], np.float32))
                         for k in self.param_names})


def load_model(model_dir: str, device) -> BrainModel:
    """Loads a saved model of a registered (ported) class onto ``device``."""
    with open(os.path.join(model_dir, 'model.json')) as f:
        meta = json.load(f)
    cls = _MODEL_REGISTRY.get(meta['model_class'])
    if cls is None:
        raise ValueError('Model class %s is not ported to '
                         'telluride_decoding_torch yet (ported: %s).'
                         % (meta['model_class'], sorted(_MODEL_REGISTRY)))
    with np.load(os.path.join(model_dir, 'weights.npz')) as npz:
        flat = {k: npz[k] for k in npz.files}
    model = cls.from_numpy(flat, device, meta['config'])
    model.telluride_metadata = meta.get('telluride_metadata')
    model.telluride_inputs = meta.get('telluride_inputs')
    model.telluride_output = meta.get('telluride_output')
    return model
