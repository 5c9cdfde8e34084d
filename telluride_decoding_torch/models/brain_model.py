"""Brain models (port of models/brain_model.py:40-430): the base class
and the deterministic linear regression.

A model is an ``nn.Module`` whose parameters are buffers (the fits are
deterministic, no gradient). ``save``/``load_model`` read and write the
JAX package's directory format: ``model.json`` (class name, constructor
config, telluride metadata) and ``weights.npz`` keyed as its
``_flat_key`` keys a params dict, so a model directory written by either
package loads in the other.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from telluride_decoding_torch import device as device_policy
from telluride_decoding_torch.data.brain_data import BrainDataset
from telluride_decoding_torch.ops import pearson
from telluride_decoding_torch.solvers import ridge


def dataset_arrays(dataset) -> Tuple[np.ndarray, np.ndarray,
                                     np.ndarray, np.ndarray]:
    """(input_1, input_2, output, attended) arrays of a dataset.

    A BrainDataset without batch transforms gives its whole arrays;
    with mixup or mismatch, one epoch of its batches. Any other iterable
    of (input_dict, output) minibatches is concatenated.
    """
    if isinstance(dataset, BrainDataset):
        if not dataset.has_batch_transforms:
            return dataset.all_arrays()
        # Transforms must run, over one epoch only.
        dataset = dataset.iter_one_epoch()
    xs, x2s, ys, ats = [], [], [], []
    for inputs, y in dataset:
        xs.append(np.asarray(inputs['input_1']))
        x2s.append(np.asarray(inputs['input_2']))
        ats.append(np.asarray(inputs.get('attended_speaker',
                                         np.zeros((len(y), 1)))))
        ys.append(np.asarray(y))
    if not xs:
        raise ValueError('Dataset produced no batches.')
    return (np.concatenate(xs), np.concatenate(x2s),
            np.concatenate(ys), np.concatenate(ats))


_MODEL_REGISTRY: Dict[str, type] = {}


def register_model(cls):
    _MODEL_REGISTRY[cls.__name__] = cls
    return cls


class BrainModel(torch.nn.Module):
    """Base model: buffers + forward + metrics + save.

    Subclasses name their buffers in ``param_names`` and implement
    ``forward(input_dict)``, ``config()`` and ``from_numpy``. With a
    ``tensorboard_dir``, evaluations and summaries go to a timestamped
    directory under it, as in the JAX package.
    """

    loss_name = 'mse'
    metric_names: Sequence[str] = ('pearson_correlation_first',)
    param_names: Sequence[str] = ()

    def __init__(self, device, tensorboard_dir: Optional[str] = None):
        super().__init__()
        self.device = device_policy.resolve(device)
        if tensorboard_dir:
            self._tensorboard_dir = os.path.join(
                tensorboard_dir,
                datetime.datetime.now().strftime('%Y%m%d-%H%M%S'))
        else:
            self._tensorboard_dir = None
        self._compiled: Dict[str, Any] = {}
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

    @property
    def tensorboard_dir(self) -> Optional[str]:
        return self._tensorboard_dir

    def compile(self, learning_rate: float = 1e-3, **kwargs):
        """Records training hyperparameters; ``loss='pearson'`` makes
        evaluate report the Pearson loss."""
        self._compiled = dict(learning_rate=learning_rate, **kwargs)

    def as_tensor(self, value) -> torch.Tensor:
        """A model input on this model's device (float stays float)."""
        value = device_policy.as_tensor(value, self.device)
        return value if value.is_floating_point() else value.float()

    def predict(self, dataset) -> np.ndarray:
        in1, in2, _, _ = dataset_arrays(dataset)
        return self({'input_1': in1, 'input_2': in2}).cpu().numpy()

    # -- metrics -------------------------------------------------------------

    def _metric(self, name: str, y_true: torch.Tensor,
                y_pred: torch.Tensor) -> torch.Tensor:
        if name in ('mse', 'loss_mse'):
            return torch.mean(torch.square(y_true - y_pred))
        if name == 'pearson_correlation_first':
            return pearson.pearson_correlation_first(y_true, y_pred)
        if name == 'pearson_correlation_second':
            return pearson.pearson_correlation_second(y_true, y_pred)
        if name == 'pearson_correlation':
            return torch.mean(pearson.pearson_correlation(y_true, y_pred))
        if name in ('cca_pearson_correlation_first',
                    'cca_pearson_correlation_second'):
            half = y_pred.shape[-1] // 2
            metric = (pearson.pearson_correlation_first
                      if name.endswith('first') else
                      pearson.pearson_correlation_second)
            return metric(y_pred[:, :half], y_pred[:, half:])
        if name == 'accuracy':
            return torch.mean(((y_pred > 0.5).float() == y_true).float())
        if name == 'binary_crossentropy':
            p = torch.clamp(y_pred, 1e-7, 1 - 1e-7)
            return -torch.mean(y_true * torch.log(p) +
                               (1 - y_true) * torch.log(1 - p))
        raise ValueError('Unknown metric %s' % name)

    def _scores(self, y_true: torch.Tensor,
                y_pred: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Loss and metrics of one split or batch; the loss is the
        Pearson training objective after ``compile(loss='pearson')``."""
        if self._compiled.get('loss') == 'pearson':
            loss = torch.sum(pearson.pearson_loss(y_true, y_pred))
        else:
            loss = self._metric(self.loss_name, y_true, y_pred)
        results = {'loss': loss}
        for name in self.metric_names:
            results[name] = self._metric(name, y_true, y_pred)
        return results

    def evaluate(self, dataset, epoch_count: int = 1) -> Dict[str, float]:
        """Loss and metrics over a dataset (the JAX evaluate,
        telluride_decoding_tpu/models/brain_model.py:175-237).

        One metric over the whole split, or, for a dataset of the
        reference protocol, the mean of per-batch metrics (Keras
        evaluate semantics).
        """
        in1, in2, out, _ = dataset_arrays(dataset)
        ref_bs = getattr(dataset, 'reference_batch_size', None)
        n_batches = (in1.shape[0] // ref_bs
                     if ref_bs and in1.shape[0] >= ref_bs else 0)
        with torch.no_grad():
            y_pred = self({'input_1': in1, 'input_2': in2})
            y_true = self.as_tensor(out)
            if n_batches:
                per_batch = [self._scores(t, p) for t, p in zip(
                    y_true.split(ref_bs), y_pred.split(ref_bs))]
                results = {k: torch.stack([b[k] for b in per_batch]).mean()
                           for k in per_batch[0]}
            else:
                results = self._scores(y_true, y_pred)
        # Sorted by name, the order of the JAX package's result dict.
        metrics = {k: float(results[k]) for k in sorted(results)}
        if self._tensorboard_dir:
            from telluride_decoding_torch.utils import summaries
            writer = summaries.SummaryWriter(
                os.path.join(self._tensorboard_dir, 'results'))
            for name, val in metrics.items():
                writer.scalar(name, val, step=epoch_count)
        return metrics

    # -- metadata ------------------------------------------------------------

    def add_metadata(self, flags, dataset=None):
        """Stores the experiment flags (lag contexts etc.) and, given a
        dataset, its input and output widths with the model."""
        self.telluride_metadata = json.dumps(flags)
        if dataset is None:
            return
        if isinstance(dataset, BrainDataset):
            spec_in, spec_out = dataset.element_spec
            inputs = {'input_1': [None, spec_in['input_1'][0]],
                      'input_2': [None, spec_in['input_2'][0]],
                      'attended_speaker':
                          [None, spec_in['attended_speaker'][0]]}
            output = [None, spec_out[0]]
        else:
            inputs = output = None
            for input_dict, y in dataset:
                inputs = {k: [None, int(np.asarray(v).shape[-1])]
                          for k, v in input_dict.items()}
                output = [None, int(np.asarray(y).shape[-1])]
                break
            if inputs is None:
                raise ValueError('add_metadata dataset produced no '
                                 'batches; cannot infer I/O shapes.')
        self.telluride_inputs = json.dumps(inputs)
        self.telluride_output = json.dumps(output)

    def add_tensorboard_summary(self, name, data, subdir='train', step=0):
        if not isinstance(name, str):
            raise TypeError('Tensorboard name must be a string, not a %s.' %
                            type(name))
        if not isinstance(subdir, str):
            raise TypeError('Tensorboard subdir must be a string, not a %s.'
                            % type(subdir))
        if self._tensorboard_dir:
            from telluride_decoding_torch.utils import summaries
            writer = summaries.SummaryWriter(
                os.path.join(self._tensorboard_dir, subdir))
            writer.text(name, str(data), step=step)

    def summary(self) -> str:
        """Prints and returns the parameter shapes, named as in
        weights.npz."""
        lines = ['Model: %s' % type(self).__name__]
        total = 0
        for name, value in sorted((self.params or {}).items()):
            lines.append('  %s: %s' % (name, tuple(value.shape)))
            total += value.numel()
        lines.append('Total params: %d' % total)
        text = '\n'.join(lines)
        print(text)
        return text

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


@register_model
class BrainModelLinearRegression(BrainModel):
    """Linear (ridge or shrinkage) regression with a deterministic fit
    (telluride_decoding_tpu/models/brain_model.py:359-429). Buffers:
    w [Dx, Dy], b [Dy]."""

    loss_name = 'mse'
    metric_names = ('pearson_correlation_first',)
    param_names = ('w', 'b')

    def __init__(self, input_dataset=None, regularization_lambda: float = 0.0,
                 tensorboard_dir: Optional[str] = None,
                 input_width: Optional[int] = None,
                 output_width: Optional[int] = None, *, device):
        super().__init__(device, tensorboard_dir)
        if input_dataset is not None:
            spec_in, spec_out = input_dataset.element_spec
            input_width = spec_in['input_1'][-1]
            output_width = spec_out[-1]
        self._input_width = input_width
        self._output_width = output_width
        self._regularization_lambda = regularization_lambda

    def config(self):
        return {'regularization_lambda': self._regularization_lambda,
                'input_width': self._input_width,
                'output_width': self._output_width}

    @classmethod
    def from_numpy(cls, flat: Dict[str, np.ndarray], device,
                   config: Optional[dict] = None
                   ) -> 'BrainModelLinearRegression':
        from telluride_decoding_torch.models.convert import (
            linear_params_from_numpy)
        return linear_params_from_numpy(flat, device, config)

    def forward(self, input_dict) -> torch.Tensor:
        """[N, Dx] -> [N, Dy]: x @ w + b, in float32."""
        if self.params is None:
            raise ValueError('Model must be fit or loaded before calling.')
        return self.as_tensor(input_dict['input_1']).float() @ self.w + self.b

    def fit(self, dataset, epochs: int = 1, **kwargs) -> Dict[str, Any]:
        """One covariance pass over the dataset's arrays and a solve."""
        del epochs, kwargs  # Deterministic: one pass.
        in1, _, out, _ = dataset_arrays(dataset)
        solution = ridge.calculate_linear_regressor_parameters(
            device_policy.as_tensor(in1, self.device, torch.float32),
            device_policy.as_tensor(out, self.device, torch.float32),
            lamb=self._regularization_lambda)
        self._set_solution(solution)
        return {}

    def fit_streaming(self, brain_data, mode: str = 'train',
                      epochs: int = 1, **kwargs) -> Dict[str, Any]:
        """Bounded-memory fit: per-file streamed moments of (input_1,
        output), each file lag stacked on the device (kernel K2 on
        CUDA), then the same solve."""
        del epochs, kwargs  # Deterministic: one pass.
        stats = brain_data.streaming_moments(mode, y_source='output')
        solution = ridge.solve_ridge_from_moments(
            type(stats)(*(t.to(self.device) for t in stats)),
            lamb=self._regularization_lambda)
        self._set_solution(solution)
        return {}

    def _set_solution(self, solution: ridge.RidgeSolution):
        self.set_params({'w': solution.w, 'b': solution.b})

    @property
    def weight_matrices(self) -> List[np.ndarray]:
        return [self.w.cpu().numpy(), self.b.cpu().numpy()]
