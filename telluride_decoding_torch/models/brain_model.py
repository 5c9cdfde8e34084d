"""Brain models (port of models/brain_model.py): the base class, the
deterministic linear regression and the SGD families (a DNN regressor
and a match-mismatch classifier; the deep CCA is in models/cca.py).

A model is an ``nn.Module``. The linear regression keeps its parameters
as buffers (its fit is deterministic, no gradient). An SGD model keeps a
dict of float32 tensors keyed by the JAX package's ``_flat_key`` names
(``layers/0/w``, ``bn/0/gamma``, ``0/w``, ``tower1/0/w``, ``rot1``), with
every dense weight laid out [in, out] as there, and trains them with
torch autograd and ``torch.optim.Adam`` at optax's settings.
``save``/``load_model`` read and write the JAX package's directory
format: ``model.json`` (class name, constructor config, telluride
metadata) and ``weights.npz`` under those names, so a model directory
written by either package loads in the other.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import warnings
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
    # Registers BrainModelCCA and BrainModelDCCA.
    from telluride_decoding_torch.models import cca  # noqa: F401
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


# -- SGD models ---------------------------------------------------------------

def _mlp_keys(widths: Sequence[int], prefix: str = '') -> List[Tuple[str,
                                                                      tuple]]:
    """(name, shape) of a dense stack's parameters in the JAX package's
    leaf order: per layer i, ``{prefix}{i}/b`` [out] then
    ``{prefix}{i}/w`` [in, out]."""
    keys = []
    for i in range(len(widths) - 1):
        keys.append(('%s%d/b' % (prefix, i), (widths[i + 1],)))
        keys.append(('%s%d/w' % (prefix, i), (widths[i], widths[i + 1])))
    return keys


def _init_mlp(gen: torch.Generator, widths: Sequence[int],
              prefix: str = '') -> Dict[str, torch.Tensor]:
    """He-initialised dense stack (JAX brain_model.py:432-441): w drawn
    from ``gen`` times sqrt(2 / fan_in), b zero."""
    params = {}
    for i in range(len(widths) - 1):
        params['%s%d/b' % (prefix, i)] = torch.zeros(widths[i + 1])
        params['%s%d/w' % (prefix, i)] = torch.randn(
            (widths[i], widths[i + 1]), generator=gen) * math.sqrt(
                2.0 / widths[i])
    return params


def _apply_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
               layers: int, prefix: str = '',
               final_activation=None) -> torch.Tensor:
    """Dense stack with ReLU hidden layers (dropout lives in
    BrainModelDNN._forward, the only model that trains with it)."""
    for i in range(layers):
        x = x @ params['%s%d/w' % (prefix, i)] + params['%s%d/b' % (prefix, i)]
        if i < layers - 1:
            x = torch.relu(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x


class _SgdModel(BrainModel):
    """Shared SGD training (JAX brain_model.py:490-767): a dense fit over
    permuted minibatches of the whole split, and a streamed fit one file
    at a time, each step one Adam update of torch autograd's gradients.

    Subclasses give the parameter template (``param_shapes``), the
    initialisation (``_init_params``), ``forward`` and ``_loss_fn``.
    """

    def __init__(self, device, tensorboard_dir: Optional[str] = None):
        super().__init__(device, tensorboard_dir)
        self._params: Optional[Dict[str, torch.Tensor]] = None
        self._fit_arrays = None

    @property
    def params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The parameters by weights.npz name; None before a fit or
        load."""
        return self._params

    def set_params(self, values: Dict[str, torch.Tensor]):
        self._params = {
            name: torch.as_tensor(values[name]).detach().to(
                self.device, torch.float32)
            for name, _ in self.param_shapes()}
        self.params_version += 1

    def param_shapes(self) -> List[Tuple[str, tuple]]:
        raise NotImplementedError

    def _init_params(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _loss_fn(self, params, inputs, y_true, gen=None) -> torch.Tensor:
        raise NotImplementedError

    @classmethod
    def from_numpy(cls, flat: Dict[str, np.ndarray], device,
                   config: Optional[dict] = None) -> '_SgdModel':
        from telluride_decoding_torch.models.convert import (
            sgd_params_from_numpy)
        return sgd_params_from_numpy(cls.__name__, flat, device, config)

    def _restore_params(self, flat: Dict[str, np.ndarray]):
        """Sets the parameters from the flattened weights.npz dict. A DNN
        checkpoint from before batch norm stored its layers as ``0/w``;
        those names stand in for ``layers/0/w``."""
        if not flat:
            self._params = None
            self.params_version += 1
            return
        values = {}
        for key, _ in self.param_shapes():
            if key not in flat and key.startswith('layers/'):
                legacy = key[len('layers/'):]
                if legacy in flat:
                    values[key] = flat[legacy]
                    continue
            if key not in flat:
                raise ValueError(
                    'Checkpoint is missing weight %r (has %s); was it saved '
                    'by an incompatible model config?' % (key, sorted(flat)))
            values[key] = flat[key]
        self.set_params({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in values.items()})

    def _require_params(self) -> Dict[str, torch.Tensor]:
        if self._params is None:
            raise ValueError('Model must be fit or loaded before calling.')
        return self._params

    def _trainable(self, seed: int) -> Dict[str, torch.Tensor]:
        """Copies of the parameters (initialised from ``seed`` when there
        are none) that autograd tracks; a refit starts from the current
        parameters, as in the JAX package."""
        if self._params is None:
            self.set_params(self._init_params(
                torch.Generator().manual_seed(seed)))
        return {k: v.clone().requires_grad_(True)
                for k, v in self._params.items()}

    def _optimizer(self, params: Dict[str, torch.Tensor]):
        # optax.adam's defaults (eps_root 0) in torch's form.
        return torch.optim.Adam(list(params.values()),
                                lr=self._compiled.get('learning_rate', 1e-3),
                                betas=(0.9, 0.999), eps=1e-8)

    def _step(self, params, opt, x1, x2, y, gen) -> torch.Tensor:
        """One Adam update on one minibatch; returns the batch's loss."""
        opt.zero_grad(set_to_none=True)
        loss = self._loss_fn(params, {'input_1': x1, 'input_2': x2}, y, gen)
        loss.backward()
        opt.step()
        return loss.detach()

    def _dropout_generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def fit(self, dataset, epochs: int = 1, batch_size: int = 512,
            seed: int = 0, _keep_arrays: bool = False,
            **kwargs) -> Dict[str, Any]:
        """Dense SGD fit (JAX brain_model.py:497-634) over the dataset's
        whole arrays on the model's device.

        Every epoch draws a permutation of the frames from a generator
        seeded with ``seed``, pads it to whole batches by wrapping its
        head (ceil, not floor: every frame gets a gradient) and takes one
        Adam step a minibatch; dropout draws from a generator seeded with
        ``seed + 1``. Returns {'loss': [mean batch loss of each epoch]}.
        """
        del kwargs
        in1, in2, out, _ = dataset_arrays(dataset)
        n = in1.shape[0]
        if n == 0:
            raise ValueError('Dataset produced no batches.')
        total_bytes = in1.nbytes + in2.nbytes + out.nbytes
        try:
            warn_bytes = int(float(os.environ.get('TDT_STREAMING_AUTO_BYTES',
                                                  1 << 30)))
        except ValueError:
            warn_bytes = 1 << 30
        if warn_bytes > 0 and total_bytes > warn_bytes:
            if total_bytes >= 1 << 30:
                size = '%.1f GB' % (total_bytes / 2**30)
            else:
                size = '%.1f MB' % (total_bytes / 2**20)
            warnings.warn(
                'SGD fit materializes %s of (lag-stacked) '
                'training data on device; consider fit_streaming '
                '(--streaming_fit), which holds one file on the host '
                'and one minibatch on device instead.' % size)
        batch_size = min(batch_size, n)
        num_batches = max(-(-n // batch_size), 1)
        perm_gen = torch.Generator().manual_seed(seed)
        params = self._trainable(seed)
        opt = self._optimizer(params)
        drop_gen = self._dropout_generator(seed + 1)
        x1, x2, y = (device_policy.as_tensor(a, self.device, torch.float32)
                     for a in (in1, in2, out))
        pad = num_batches * batch_size - n
        epoch_losses = []
        for _ in range(epochs):
            perm = torch.randperm(n, generator=perm_gen)
            if pad:
                perm = torch.cat([perm, perm[:pad]])
            total = torch.zeros((), device=self.device)
            for idx in perm.to(self.device).reshape(num_batches, batch_size):
                total += self._step(params, opt, x1[idx], x2[idx], y[idx],
                                    drop_gen)
            epoch_losses.append(total / num_batches)
        self.set_params(params)
        if _keep_arrays:
            # The subclass's pass over the same arrays clears it.
            self._fit_arrays = (x1, x2, y)
        return {'loss': [float(l) for l in epoch_losses]}

    def fit_streaming(self, brain_data, mode: str = 'train',
                      epochs: int = 1, batch_size: int = 512,
                      seed: int = 0, **kwargs) -> Dict[str, Any]:
        """Bounded-memory SGD fit (JAX brain_model.py:655-767): one file
        of the mode on the model's device at a time.

        The file order and each file's permutation come from
        ``np.random.RandomState(seed)`` in the JAX package's order, so
        the batches are the JAX fit's. Leftover rows carry across files,
        so every batch is full, and the epoch's final partial batch is
        dropped; a corpus smaller than one batch trains as one short
        batch.
        """
        del kwargs
        params = self._trainable(seed)
        opt = self._optimizer(params)
        drop_gen = self._dropout_generator(seed + 1)
        rng = np.random.RandomState(seed)
        history = []
        for _ in range(epochs):
            order = list(brain_data.filter_file_names(mode))
            if not order:
                raise ValueError('No files to process in mode %s.' % mode)
            rng.shuffle(order)
            carry = None
            losses = []
            for _, (in1, in2, out, _) in brain_data.iter_file_arrays(
                    mode, filenames=order):
                perm = rng.permutation(in1.shape[0])
                parts = tuple(device_policy.as_tensor(a[perm], self.device,
                                                      torch.float32)
                              for a in (in1, in2, out))
                if carry is not None:
                    parts = tuple(torch.cat([c, p])
                                  for c, p in zip(carry, parts))
                n = parts[0].shape[0]
                usable = (n // batch_size) * batch_size
                for start in range(0, usable, batch_size):
                    losses.append(self._step(
                        params, opt,
                        *(p[start:start + batch_size] for p in parts),
                        drop_gen))
                carry = (tuple(p[usable:] for p in parts)
                         if usable < n else None)
            if not losses:
                if carry is None or carry[0].shape[0] == 0:
                    raise ValueError('Dataset produced no batches.')
                losses.append(self._step(params, opt, *carry, drop_gen))
            history.append(float(torch.stack(losses).mean()))
        self.set_params(params)
        return {'loss': history}


@register_model
class BrainModelDNN(_SgdModel):
    """MLP regressor (JAX brain_model.py:770-977), optionally with batch
    normalisation and dropout on the hidden layers. Parameters:
    layers/i/{b, w} and, with batch norm, bn/i/{beta, gamma, mean, var}."""

    loss_name = 'mse'
    metric_names = ('pearson_correlation_first', 'mse')

    def __init__(self, input_dataset=None, num_hidden_list=None,
                 tensorboard_dir=None, input_width=None, output_width=None,
                 dropout: float = 0.0, batch_norm: bool = False, *, device):
        super().__init__(device, tensorboard_dir)
        if num_hidden_list is None:
            num_hidden_list = []
        if not isinstance(num_hidden_list, list):
            raise TypeError('Num_hidden_list must be an list, not a %s.' %
                            type(num_hidden_list))
        if input_dataset is not None:
            spec_in, spec_out = input_dataset.element_spec
            input_width = spec_in['input_1'][-1]
            output_width = spec_out[-1]
        self._input_width = input_width
        self._output_width = output_width
        self.num_hidden_list = num_hidden_list
        if not 0.0 <= dropout < 1.0:
            raise ValueError('dropout must be in [0, 1), not %g.' %
                             dropout)
        self._dropout = float(dropout)
        # Batch statistics in training; population statistics, computed
        # in one pass over the training set after the fit, at inference.
        self._batch_norm = bool(batch_norm)

    def config(self):
        return {'num_hidden_list': self.num_hidden_list,
                'input_width': self._input_width,
                'output_width': self._output_width,
                'dropout': self._dropout,
                'batch_norm': self._batch_norm}

    def _widths(self) -> List[int]:
        return ([self._input_width] + list(self.num_hidden_list) +
                [self._output_width])

    def param_shapes(self):
        keys = []
        if self._batch_norm:
            for i, h in enumerate(self.num_hidden_list):
                keys += [('bn/%d/%s' % (i, name), (h,))
                         for name in ('beta', 'gamma', 'mean', 'var')]
        return keys + _mlp_keys(self._widths(), 'layers/')

    def _init_params(self, gen):
        params = _init_mlp(gen, self._widths(), 'layers/')
        if self._batch_norm:
            for i, h in enumerate(self.num_hidden_list):
                params.update({'bn/%d/beta' % i: torch.zeros(h),
                               'bn/%d/gamma' % i: torch.ones(h),
                               'bn/%d/mean' % i: torch.zeros(h),
                               'bn/%d/var' % i: torch.ones(h)})
        return params

    def _forward(self, params, x, training: bool, gen=None,
                 collect_stats: bool = False):
        """The MLP with per-hidden-layer batch norm (batch statistics in
        training, the stored ones otherwise) and dropout (when given a
        generator); with ``collect_stats`` also each hidden layer's
        batch mean and variance."""
        layers = len(self._widths()) - 1
        stats = []
        for i in range(layers):
            x = x @ params['layers/%d/w' % i] + params['layers/%d/b' % i]
            if i == layers - 1:
                break
            if self._batch_norm:
                if training or collect_stats:
                    batch = (torch.mean(x, dim=0),
                             torch.var(x, dim=0, correction=0))
                if collect_stats:
                    stats.append(batch)
                mean, var = batch if training else (
                    params['bn/%d/mean' % i], params['bn/%d/var' % i])
                x = (x - mean) * torch.rsqrt(var + 1e-5)
                x = x * params['bn/%d/gamma' % i] + params['bn/%d/beta' % i]
            x = torch.relu(x)
            if self._dropout > 0.0 and gen is not None:
                keep = torch.rand(x.shape, generator=gen,
                                  device=x.device) < 1.0 - self._dropout
                x = torch.where(keep, x / (1.0 - self._dropout),
                                torch.zeros_like(x))
        return (x, stats) if collect_stats else x

    def forward(self, input_dict) -> torch.Tensor:
        return self._forward(self._require_params(),
                             self.as_tensor(input_dict['input_1']).float(),
                             training=False)

    def _loss_fn(self, params, inputs, y_true, gen=None):
        y_pred = self._forward(params, inputs['input_1'], training=True,
                               gen=gen)
        if self._compiled.get('loss') == 'pearson':
            return torch.sum(pearson.pearson_loss(y_true, y_pred))
        return torch.mean(torch.square(y_pred - y_true))

    def fit(self, dataset, epochs: int = 1, batch_size: int = 512,
            seed: int = 0, **kwargs):
        history = super().fit(dataset, epochs=epochs, batch_size=batch_size,
                              seed=seed, _keep_arrays=self._batch_norm,
                              **kwargs)
        if self._batch_norm:
            # Population statistics: one pass over the same training
            # arrays, whose full-split batch statistics they are.
            try:
                with torch.no_grad():
                    _, stats = self._forward(self.params,
                                             self._fit_arrays[0],
                                             training=True,
                                             collect_stats=True)
            finally:
                self._fit_arrays = None
            self._set_population_stats(stats)
        return history

    def _set_population_stats(self, stats):
        values = dict(self.params)
        for i, (mean, var) in enumerate(stats):
            values['bn/%d/mean' % i] = mean
            values['bn/%d/var' % i] = var
        self.set_params(values)

    def fit_streaming(self, brain_data, mode: str = 'train', **kwargs):
        history = super().fit_streaming(brain_data, mode, **kwargs)
        if self._batch_norm:
            self._set_population_stats_streaming(brain_data, mode)
        return history

    def _preact(self, params, x, upto: int) -> torch.Tensor:
        """Hidden layer ``upto``'s activation before normalisation, the
        layers below normalised by their (final) population statistics."""
        for i in range(upto + 1):
            x = x @ params['layers/%d/w' % i] + params['layers/%d/b' % i]
            if i == upto:
                return x
            x = ((x - params['bn/%d/mean' % i]) *
                 torch.rsqrt(params['bn/%d/var' % i] + 1e-5))
            x = x * params['bn/%d/gamma' % i] + params['bn/%d/beta' % i]
            x = torch.relu(x)
        return x

    @torch.no_grad()
    def _set_population_stats_streaming(self, brain_data, mode: str,
                                        frame_bucket: int = 4096):
        """Population batch-norm statistics with bounded memory (JAX
        brain_model.py:940-977): one streamed pass a hidden layer, in
        order, since layer k's input needs the final statistics of the
        layers below; each file is padded to a multiple of
        ``frame_bucket`` rows and masked. The same values as the dense
        pass up to the order of float32 sums."""
        from telluride_decoding_torch.ops.covariance import pad_to_bucket
        stats = []
        for k in range(len(self.num_hidden_list)):
            acc_s = acc_ss = None
            count = 0.0
            for _, (in1, _, _, _) in brain_data.iter_file_arrays(mode):
                (xp,), valid = pad_to_bucket([in1], in1.shape[0],
                                             frame_bucket)
                x = device_policy.as_tensor(xp, self.device)
                m = device_policy.as_tensor(valid, self.device)
                a = self._preact(self.params, x, k)
                s = torch.sum(a * m[:, None], dim=0)
                ss = torch.sum(a * a * m[:, None], dim=0)
                acc_s = s if acc_s is None else acc_s + s
                acc_ss = ss if acc_ss is None else acc_ss + ss
                count += float(torch.sum(m))
            mean = acc_s / count
            stats.append((mean, torch.clamp(acc_ss / count - mean * mean,
                                            min=0.0)))
            self._set_population_stats(stats)


@register_model
class BrainModelClassifier(_SgdModel):
    """Match-mismatch classifier (JAX brain_model.py:980-1040): an MLP
    on concat(input_1, input_2) with a sigmoid output, trained on the
    binary cross-entropy. Parameters: i/{b, w}."""

    loss_name = 'binary_crossentropy'
    metric_names = ('accuracy',)

    def __init__(self, input_dataset=None, num_hidden_list=None,
                 tensorboard_dir=None, input_width=None, input2_width=None,
                 output_width=None, *, device):
        super().__init__(device, tensorboard_dir)
        if num_hidden_list is None:
            num_hidden_list = []
        if isinstance(num_hidden_list, str):
            num_hidden_list = ([int(x) for x in num_hidden_list.split('-')]
                               if num_hidden_list else [])
        if input_dataset is not None:
            spec_in, spec_out = input_dataset.element_spec
            input_width = spec_in['input_1'][-1]
            input2_width = spec_in['input_2'][-1]
            output_width = spec_out[-1]
        self._input_width = input_width
        self._input2_width = input2_width
        self._output_width = output_width
        self.num_hidden_list = num_hidden_list

    def config(self):
        return {'num_hidden_list': self.num_hidden_list,
                'input_width': self._input_width,
                'input2_width': self._input2_width,
                'output_width': self._output_width}

    def _widths(self) -> List[int]:
        return ([self._input_width + self._input2_width] +
                list(self.num_hidden_list) + [self._output_width])

    def param_shapes(self):
        return _mlp_keys(self._widths())

    def _init_params(self, gen):
        return _init_mlp(gen, self._widths())

    def _apply(self, params, x1, x2) -> torch.Tensor:
        return _apply_mlp(params, torch.cat([x1, x2], dim=1),
                          len(self._widths()) - 1,
                          final_activation=torch.sigmoid)

    def forward(self, input_dict) -> torch.Tensor:
        return self._apply(self._require_params(),
                           self.as_tensor(input_dict['input_1']).float(),
                           self.as_tensor(input_dict['input_2']).float())

    def _loss_fn(self, params, inputs, y_true, gen=None):
        del gen
        return self._metric('binary_crossentropy', y_true,
                            self._apply(params, inputs['input_1'],
                                        inputs['input_2']))
