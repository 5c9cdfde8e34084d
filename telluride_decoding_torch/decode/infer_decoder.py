"""Attention decoding: correlation state + reductions + LDA (port of
decode/infer_decoder.py:38-717).

The per-window serving path of a CCA model with the LDA reduction
(``infer_one``/``infer_pair``) is one launch of kernel K1 per call:
rotate both inputs, form the normalized correlation, project through the
LDA, one score per frame (windows of T = 1). ``infer_pair`` scores both
audio streams against one read of the brain window. The other reductions
run as plain torch, as ``_reduce`` does in the JAX package.

``decoder_model.json`` stays wire-compatible with the JAX package and the
reference: the same ModelParams namedtuple structure, complex arrays
split re/im (NumpyEncoder).
"""

from __future__ import annotations

import collections
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from telluride_decoding_torch import device as device_policy
from telluride_decoding_torch.decode.metrics import (average_data,
                                                     calculate_dprime)
from telluride_decoding_torch.ops.decode_kernel import (FoldedDecode,
                                                        fold_decode_params,
                                                        fused_cca_decode)
from telluride_decoding_torch.solvers import lda as scaled_lda

CorrelationParamsTuple = collections.namedtuple('CorrelationParamsTuple', [
    'count', 'sum_x', 'sum_y', 'sum_x2', 'sum_y2', 'mean_x', 'mean_y',
    'power'])
ModelParamsTuple = collections.namedtuple('ModelParamsTuple',
                                          ['correlation_params',
                                           'lda_params'])

REDUCTIONS = ('mean-squared', 'first', 'second', 'lda', 'all', 'mean')


class NumpyEncoder(json.JSONEncoder):
    """JSON encoder splitting complex arrays into [re, im] lists
    (reference infer_decoder.py:75-86 schema)."""

    def default(self, obj: Any):
        if isinstance(obj, np.ndarray):
            if np.iscomplexobj(obj):
                return [np.real(obj).tolist(), np.imag(obj).tolist()]
            return obj.tolist()
        if isinstance(obj, (np.floating, np.integer)):
            return obj.item()
        return json.JSONEncoder.default(self, obj)


def _reduce(correlations: torch.Tensor, reduction: str,
            lda_w: Optional[torch.Tensor], lda_slope, lda_intercept):
    """Applies the chosen reduction to [N, D] correlations."""
    if reduction == 'first':
        return correlations[:, 0]
    if reduction == 'second':
        return correlations[:, 1]
    if reduction == 'mean':
        return torch.mean(correlations, dim=1)
    if reduction == 'mean-squared':
        return torch.mean(torch.sign(correlations) * correlations ** 2,
                          dim=1)
    if reduction == 'lda':
        return lda_slope * (correlations @ lda_w)[:, 0] + lda_intercept
    if reduction == 'all':
        return correlations
    raise ValueError('Unknown reduction technique: %s.' % reduction)


class _Pipeline(collections.namedtuple('_Pipeline',
                                       ['folded', 'correlate_reduce'])):
    """What a decoder serves with, built from the current statistics:
    ``folded`` (kernel K1's parameters) when the fused decode applies,
    else None and ``correlate_reduce(r1, r2)`` in plain torch."""


class Decoder:
    """Base decoder: correlation statistics + reduction + LDA.

    ``decoding_model`` is a port model (``BrainModel``); ``device`` is
    where decoding runs.
    """

    def __init__(self, decoding_model: Optional[Callable] = None,
                 reduction: str = 'mean-squared', *, device):
        if decoding_model is not None and not callable(decoding_model):
            raise TypeError('Must supply a callable model when initializing '
                            'a Decoder, not a %s.' % type(decoding_model))
        if reduction not in REDUCTIONS:
            raise ValueError('Unknown reduction technique: %s' % reduction)
        self._device = device_policy.resolve(device)
        self._decoding_model = decoding_model
        self._decoding_model_params: Dict[str, Any] = {}
        self._reduction = reduction
        self._lda: Optional[scaled_lda.ScaledLinearDiscriminantAnalysis] = \
            None
        # (model identity, params_version) the cached pipeline was built
        # against: a refit bumps the version.
        self._built_key: Any = None
        self.reset_correlation_statistics()

    # -- properties -----------------------------------------------------------

    @property
    def decoding_model(self):
        return self._decoding_model

    @property
    def decoding_model_params(self) -> Dict[str, Any]:
        return self._decoding_model_params

    @decoding_model_params.setter
    def decoding_model_params(self, values: Dict[str, Any]):
        self._decoding_model_params = values

    @property
    def correlation_params(self) -> CorrelationParamsTuple:
        return CorrelationParamsTuple(
            self._count, self._sum_x, self._sum_y, self._sum_x2,
            self._sum_y2, self._mean_x, self._mean_y, self._power)

    def _set_correlation_params(self, values):
        values = CorrelationParamsTuple(*values)
        self._count = values.count
        self._sum_x = np.asarray(values.sum_x)
        self._sum_y = np.asarray(values.sum_y)
        self._sum_x2 = np.asarray(values.sum_x2)
        self._sum_y2 = np.asarray(values.sum_y2)
        self._mean_x = np.asarray(values.mean_x)
        self._mean_y = np.asarray(values.mean_y)
        self._power = np.asarray(values.power)

    @property
    def lda_params(self) -> scaled_lda.LdaParams:
        if self._lda is None:
            self._lda = scaled_lda.ScaledLinearDiscriminantAnalysis(
                self._device)
        return self._lda.model_parameters

    def _set_lda_params(self, values):
        if self._lda is None:
            self._lda = scaled_lda.ScaledLinearDiscriminantAnalysis(
                self._device)
        self._lda.model_parameters = scaled_lda.LdaParams(*values)

    @property
    def model_params(self) -> ModelParamsTuple:
        return ModelParamsTuple(self.correlation_params, self.lda_params)

    @model_params.setter
    def model_params(self, values: ModelParamsTuple):
        self._set_correlation_params(values.correlation_params)
        self._set_lda_params(values.lda_params)
        # The pipeline holds tensors of the statistics and LDA
        # parameters; new values must rebuild it.
        self._pipeline = None

    def reset_correlation_statistics(self):
        self._count = 0
        self._sum_x = 0.0
        self._sum_y = 0.0
        self._sum_x2 = 0.0
        self._sum_y2 = 0.0
        self._mean_x = 0.0
        self._mean_y = 0.0
        self._power = 1.0
        self._pipeline: Optional[_Pipeline] = None

    # -- persistence (decoder_model.json compatible) --------------------------

    def save_parameters(self, param_filename: str):
        os.makedirs(os.path.dirname(os.path.abspath(param_filename)),
                    exist_ok=True)
        with open(param_filename, 'w') as f:
            json.dump(self.model_params._asdict(), f, cls=NumpyEncoder)

    def restore_parameters(self, param_filename: str):
        with open(param_filename, 'r') as f:
            loaded = json.load(f)
        self.model_params = ModelParamsTuple(**loaded)

    def load_decoding_model(self, saved_model_dir: str):
        """Loads a saved model (model.json + weights.npz) and the
        experiment flags embedded in it (the lag contexts serving needs)."""
        from telluride_decoding_torch.models.brain_model import load_model
        if not saved_model_dir or not isinstance(saved_model_dir, str):
            raise TypeError('Must provide a file name (string) to '
                            'load-model, not a %s.' % type(saved_model_dir))
        self._decoding_model = load_model(saved_model_dir, self._device)
        model = self._decoding_model
        if model.telluride_metadata:
            self._decoding_model_params = json.loads(model.telluride_metadata)
        self._pipeline = None

    # -- correlation statistics ------------------------------------------------

    def add_data_correlator(self, x: np.ndarray, y: np.ndarray):
        """Online update of the correlation normalization statistics
        (reference infer_decoder.py:288-311)."""
        x = np.asarray(x)
        y = np.asarray(y)
        self._count += x.shape[0]
        self._sum_x = self._sum_x + np.sum(x, axis=0)
        self._sum_y = self._sum_y + np.sum(y, axis=0)
        self._sum_x2 = self._sum_x2 + np.sum(x ** 2, axis=0)
        self._sum_y2 = self._sum_y2 + np.sum(y ** 2, axis=0)
        self._mean_x = self._sum_x / self._count
        self._mean_y = self._sum_y / self._count
        self._power = (np.sqrt(
            (self._sum_x2 - self._sum_x ** 2 / self._count) *
            (self._sum_y2 - self._sum_y ** 2 / self._count)) / self._count)
        self._pipeline = None

    def compute_correlation(self, x, y) -> np.ndarray:
        """Normalized cross product per frame, before the time sum."""
        x = np.asarray(x)
        y = np.asarray(y)
        return ((x - np.broadcast_to(self._mean_x, x.shape)) *
                (y - np.broadcast_to(self._mean_y, y.shape)) / self._power)

    # -- decoding ---------------------------------------------------------------

    def decode_one(self, input_dict, ground_truth):
        raise NotImplementedError('Must be implemented by a subclass.')

    def _decode_tensors(self, input_dict: Dict[str, torch.Tensor],
                        ground_truth: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(r1, r2) tensors of one minibatch."""
        raise NotImplementedError('Must be implemented by a subclass.')

    def _fold(self, mean_x, mean_y, power, lda_w, lda_slope,
              lda_intercept) -> Optional[FoldedDecode]:
        """Kernel K1's parameters where the fused decode applies."""
        del mean_x, mean_y, power, lda_w, lda_slope, lda_intercept
        return None

    def _tensor(self, value) -> torch.Tensor:
        """A float32 input on this decoder's device."""
        return device_policy.as_tensor(value, self._device,
                                       torch.float32).contiguous()

    def _build_pipeline(self) -> _Pipeline:
        reduction = self._reduction
        mean_x, mean_y, power = (
            self._tensor(v) for v in (self._mean_x, self._mean_y,
                                      self._power))
        if reduction == 'lda':
            if self._lda is None or self._lda.coef_array is None:
                raise ValueError('Must compute the LDA model before '
                                 'reducing data (train the decoder or '
                                 'restore_parameters first).')
            lda_w = self._tensor(np.real(self._lda.coef_array))
            lda_slope = self._tensor(self._lda.slope)
            lda_intercept = self._tensor(self._lda.intercept)
            folded = self._fold(mean_x, mean_y, power, lda_w, lda_slope,
                                lda_intercept)
        else:
            lda_w, lda_slope, lda_intercept, folded = None, 0.0, 0.0, None

        def correlate_reduce(r1, r2):
            correlations = (r1 - mean_x) * (r2 - mean_y) / power
            return _reduce(correlations, reduction, lda_w, lda_slope,
                           lda_intercept)
        return _Pipeline(folded, correlate_reduce)

    def _invalidate_stale_pipelines(self):
        """Drops the cached pipeline when the model was refit or
        replaced (its tensors derive from the model's parameters)."""
        model = self._decoding_model
        key = (id(model), getattr(model, 'params_version', None))
        if key != self._built_key:
            self._pipeline = None
            self._built_key = key

    @torch.no_grad()
    def _scores(self, x1: torch.Tensor, x2s: List[torch.Tensor],
                outputs: List[Any]) -> List[torch.Tensor]:
        self._invalidate_stale_pipelines()
        if self._pipeline is None:
            self._pipeline = self._build_pipeline()
        folded, correlate_reduce = self._pipeline
        if folded is not None:
            # Kernel K1, per-frame scores: windows of one frame.
            scores = fused_cca_decode(
                folded, x1[:, None, :], x2s[0][:, None, :],
                x2s[1][:, None, :] if len(x2s) > 1 else None)
            return [scores] if len(x2s) == 1 else list(scores)
        return [correlate_reduce(*self._decode_tensors(
            {'input_1': x1, 'input_2': x2}, self._tensor(y)))
            for x2, y in zip(x2s, outputs)]

    def infer_one(self, input_dict, output) -> np.ndarray:
        """Scores of one minibatch: [N] (or [N, D] for 'all')."""
        (scores,) = self._scores(self._tensor(input_dict['input_1']),
                                 [self._tensor(input_dict['input_2'])],
                                 [output])
        return scores.cpu().numpy()

    def infer_pair(self, input_1, input_2a, input_2b, output_a,
                   output_b) -> Tuple[np.ndarray, np.ndarray]:
        """Scores BOTH candidate streams against one brain window; with
        the fused decode, one kernel launch reads input_1 once.
        Value-identical to two infer_one calls."""
        scores_a, scores_b = self._scores(
            self._tensor(input_1),
            [self._tensor(input_2a), self._tensor(input_2b)],
            [output_a, output_b])
        return scores_a.cpu().numpy(), scores_b.cpu().numpy()

    # -- training ------------------------------------------------------------------

    def train(self, data0, data1, window_size: int = 0) -> float:
        """Estimates correlation statistics + LDA from two datasets.

        data0: class-0 (unattended/mixed-up); data1: class-1 (attended);
        each an iterable of (input_dict, output) minibatches.
        """
        decoded0 = self._decode_dataset(data0)
        decoded1 = self._decode_dataset(data1)
        self.reset_correlation_statistics()
        for r1, r2 in (decoded0, decoded1):
            self.add_data_correlator(r1, r2)
        corr0 = self.compute_correlation(*decoded0)
        corr1 = self.compute_correlation(*decoded1)
        if corr0.shape[0] == 0:
            raise ValueError('No data for class 0')
        if corr1.shape[0] == 0:
            raise ValueError('No data for class 1')
        return self.compute_lda_model(average_data(corr0, window_size),
                                      average_data(corr1, window_size))

    def _decode_dataset(self, dataset) -> Tuple[np.ndarray, np.ndarray]:
        r1_parts, r2_parts = [], []
        for input_dict, output in dataset:
            r1, r2 = self.decode_one(input_dict, output)
            r1_parts.append(np.asarray(r1))
            r2_parts.append(np.asarray(r2))
        if not r1_parts:
            return (np.zeros((0, 1), np.float32),) * 2
        return np.concatenate(r1_parts), np.concatenate(r2_parts)

    def compute_lda_model(self, d1: np.ndarray, d2: np.ndarray) -> float:
        """Fits scaled LDA separating class 0 (label 1) from class 1
        (label 2); returns d' (reference infer_decoder.py:506-533)."""
        if not isinstance(d1, np.ndarray):
            raise TypeError('Input d1 must be an numpy array, not %s.' %
                            type(d1))
        if not isinstance(d2, np.ndarray):
            raise TypeError('Input d2 must be an numpy array, not %s.' %
                            type(d2))
        data = np.concatenate((d1, d2), axis=0)
        labels = np.concatenate((1 * np.ones(d1.shape[0]),
                                 2 * np.ones(d2.shape[0])))
        self._lda = scaled_lda.ScaledLinearDiscriminantAnalysis(self._device)
        predictions = self._lda.fit_transform(data, labels)
        self._pipeline = None
        return float(calculate_dprime(predictions[labels == 1, 0],
                                      predictions[labels == 2, 0]))

class CCADecoder(Decoder):
    """Decoder splitting CCA model output into its two rotated halves."""

    def decode_one(self, input_dict, ground_truth):
        del ground_truth
        with torch.no_grad():
            predictions = self._decoding_model(
                {k: v for k, v in input_dict.items()
                 if k in ('input_1', 'input_2')}).cpu().numpy()
        half = predictions.shape[1] // 2
        return predictions[:, :half], predictions[:, half:]

    def _decode_tensors(self, input_dict, ground_truth):
        del ground_truth
        predictions = self._decoding_model(input_dict)
        half = predictions.shape[1] // 2
        return predictions[:, :half], predictions[:, half:]

    def _fold(self, mean_x, mean_y, power, lda_w, lda_slope, lda_intercept):
        params = getattr(self._decoding_model, 'params', None)
        if params is None:
            return None
        return fold_decode_params(dict(
            params, corr_mean_x=mean_x, corr_mean_y=mean_y,
            corr_power=power, lda_w=lda_w, lda_slope=lda_slope,
            lda_intercept=lda_intercept))


def create_decoder(model_tag: str, reduction: str = 'lda', model=None, *,
                   device) -> Decoder:
    """The Decoder subclass for a model directory or tag.

    A model directory's model.json decides; a bare tag is sniffed by
    name. Only the CCA decoder is ported: linear-regression models and
    reference SavedModel directories raise.
    """
    meta_path = os.path.join(model_tag, 'model.json')
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            model_class = json.load(f).get('model_class', '')
        if model_class == 'BrainModelCCA':
            return CCADecoder(model, reduction=reduction, device=device)
        raise ValueError('Model class %s has no ported decoder yet (the '
                         'port has CCADecoder for BrainModelCCA only).'
                         % model_class)
    if os.path.isfile(os.path.join(model_tag, 'saved_model.pb')):
        raise ValueError('Reference SavedModel directories are not ported '
                         'yet: %s.' % model_tag)
    tag = model_tag.lower()
    if 'linear' in tag or 'fullyconnected' in tag:
        raise ValueError('LinearRegressionDecoder is not ported yet (tag '
                         '%s).' % model_tag)
    if 'cca' in tag:
        return CCADecoder(model, reduction=reduction, device=device)
    raise ValueError('Couldn\'t determine model type for tag %s.' %
                     model_tag)
