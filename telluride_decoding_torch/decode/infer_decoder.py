"""Attention decoding: correlation state + reductions + LDA (port of
decode/infer_decoder.py:38-742).

The per-window serving path of a CCA model with the LDA reduction
(``infer_one``/``infer_pair``) is one launch of kernel K1 per call:
rotate both inputs, form the normalized correlation, project through the
LDA, one score per frame (windows of T = 1). For a deep CCA model K1 runs
on the towers' outputs (plain matrix products in torch first), with the
model's final CCA as its rotations. ``infer_pair`` scores both audio
streams against one read of the brain window; on the card, a push of
host arrays whose shape was seen before replays a resident push plan
(decode/push_plan.py): one copy in, K1 and one copy out as one CUDA
graph, and one wait. ``frame_scores``
scores a whole test split in one ``infer_one`` call, so its K1 launch
covers every frame of the split. The other reductions, and the linear
regression decoder, run as plain torch, as ``_reduce`` does in the JAX
package.

``decoder_model.json`` stays wire-compatible with the JAX package and the
reference: the same ModelParams namedtuple structure, complex arrays
split re/im (NumpyEncoder).
"""

from __future__ import annotations

import collections
import json
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from telluride_decoding_torch import device as device_policy
from telluride_decoding_torch.decode import push_plan, result_store
from telluride_decoding_torch.decode.metrics import (average_data,
                                                     calculate_dprime)
from telluride_decoding_torch.ops.decode_kernel import (FoldedDecode,
                                                        fold_decode_params,
                                                        fused_cca_decode,
                                                        kernel_operands,
                                                        prepared_operands)
from telluride_decoding_torch.solvers import lda as scaled_lda
from telluride_decoding_torch.utils import profiling

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
    ``folded`` (kernel K1's parameters, which rotate the kernel inputs of
    ``Decoder._kernel_inputs``) when the fused decode applies, else None
    and ``correlate_reduce(r1, r2)`` in plain torch."""


class PairProgram(torch.nn.Module):
    """A decoder's two-stream program ``(input_1, input_2a, input_2b,
    output_a, output_b) -> (scores_a, scores_b)``, built from
    ``Decoder._build_pipeline`` with the statistics, the LDA and the
    model's weights as constants: what decode/aot.py exports.

    It makes the split ``Decoder._scores`` makes. Where the fused decode
    applies (a CCA or deep CCA model with the LDA reduction) it runs the
    towers of a deep CCA model, then one op ``tdt::fused_cca_decode_f32``
    (kernel K1 on the card) over both streams, on K1's operands held as
    buffers; otherwise ``_decode_tensors`` and ``correlate_reduce`` per
    stream in plain torch.
    """

    def __init__(self, decoder: 'Decoder'):
        super().__init__()
        self._decoder = decoder
        # A submodule, so the model's buffers are the program's.
        self.model = decoder.decoding_model
        self._dims = 0
        folded, self._correlate_reduce = decoder._build_pipeline()
        if folded is not None:
            self._dims = int(folded.rot1.shape[1])
            for name, tensor in zip(('rot1', 'rot2', 'consts'),
                                    kernel_operands(folded)):
                self.register_buffer(name, tensor)

    def forward(self, input_1, input_2a, input_2b, output_a, output_b):
        decoder = self._decoder
        if self._dims:
            x1, (x2a, x2b) = decoder._kernel_inputs(input_1,
                                                    [input_2a, input_2b])
            scores = torch.ops.tdt.fused_cca_decode_f32(
                x1[:, None, :], x2a[:, None, :], x2b[:, None, :],
                self.rot1, self.rot2, self.consts, self._dims)
            return scores[0], scores[1]
        return tuple(
            self._correlate_reduce(*decoder._decode_tensors(
                {'input_1': input_1, 'input_2': x2}, y))
            for x2, y in ((input_2a, output_a), (input_2b, output_b)))


class PendingScores:
    """One score vector on its way to the host; ``np.asarray`` waits for
    the copy's event."""

    def __init__(self, host: torch.Tensor, done, device: torch.device):
        self._host = host
        self._done = done
        self._host_device = device      # The card the copy comes from.

    def __array__(self, dtype=None, copy=None):
        del copy
        with profiling.span('decoder.copy_out'):
            profiling.host_wait(self._host_device)
            self._done.synchronize()
            return np.asarray(self._host.numpy(), dtype=dtype)


class PendingPair:
    """Two score vectors copied to pinned host memory without blocking;
    unpacks into two PendingScores, ``harvest()`` waits for both."""

    def __init__(self, scores):
        done = torch.cuda.Event()
        hosts = []
        for s in scores:
            host = torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
            host.copy_(s, non_blocking=True)
            hosts.append(host)
        done.record()
        self._pending = tuple(PendingScores(h, done, s.device)
                              for h, s in zip(hosts, scores))

    def __iter__(self):
        return iter(self._pending)

    def harvest(self) -> Tuple[np.ndarray, np.ndarray]:
        return tuple(np.asarray(p) for p in self._pending)


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
        self._model_inputs: Dict[str, Any] = {}
        self._model_output: list = []
        self._reduction = reduction
        self._lda: Optional[scaled_lda.ScaledLinearDiscriminantAnalysis] = \
            None
        # (model identity, params_version) the cached pipeline was built
        # against: a refit bumps the version.
        self._built_key: Any = None
        self._push_plans = push_plan.PushPlans()
        self.reset_correlation_statistics()

    # -- properties -----------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._device

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

    @property
    def model_inputs(self) -> Dict[str, Any]:
        return self._model_inputs

    @property
    def model_output(self) -> list:
        return self._model_output

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
        """Loads a saved model, the experiment flags embedded in it (the
        lag contexts serving needs) and its input and output widths.

        A native directory (model.json + weights.npz) loads as written;
        a reference TF SavedModel directory (saved_model.pb) is migrated
        on the fly (models/migrate.py), as in the JAX package."""
        from telluride_decoding_torch.models.brain_model import load_model
        if not saved_model_dir or not isinstance(saved_model_dir, str):
            raise TypeError('Must provide a file name (string) to '
                            'load-model, not a %s.' % type(saved_model_dir))
        if (not os.path.exists(os.path.join(saved_model_dir, 'model.json'))
                and os.path.exists(os.path.join(saved_model_dir,
                                                'saved_model.pb'))):
            from telluride_decoding_torch.models.migrate import (
                load_reference_saved_model)
            self._decoding_model = load_reference_saved_model(
                saved_model_dir, device=self._device)
        else:
            self._decoding_model = load_model(saved_model_dir, self._device)
        model = self._decoding_model
        if model.telluride_metadata:
            self._decoding_model_params = json.loads(model.telluride_metadata)
        if model.telluride_inputs:
            self._model_inputs = json.loads(model.telluride_inputs)
        if model.telluride_output:
            self._model_output = json.loads(model.telluride_output)
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

    def _kernel_inputs(self, x1: torch.Tensor, x2s: List[torch.Tensor]
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """What kernel K1 rotates: the inputs themselves."""
        return x1, x2s

    def _has_towers(self) -> bool:
        """Whether ``_kernel_inputs`` runs towers on the inputs."""
        return False

    def _tensor(self, value) -> torch.Tensor:
        """A float32 input on this decoder's device; from host memory to
        the card, a blocking copy."""
        if not (isinstance(value, torch.Tensor) and value.is_cuda):
            profiling.host_wait(self._device)
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
            x1, x2s = self._kernel_inputs(x1, x2s)
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

    def _pair_scores(self, input_1, input_2a, input_2b, output_a,
                     output_b) -> List[torch.Tensor]:
        with profiling.span('decoder.copy_in'):
            x1 = self._tensor(input_1)
            x2s = [self._tensor(input_2a), self._tensor(input_2b)]
        with profiling.span('decoder.launch'):
            return self._scores(x1, x2s, [output_a, output_b])

    def _plan_key(self, input_1, input_2a, input_2b):
        """(key, operands, folded) of the resident push plan for these
        inputs, or None where the plan does not apply: a decoder off the
        card, a pipeline without K1 (no CCA model with the LDA
        reduction), a model with towers, or inputs that are not numpy
        arrays of [rows, F1] and [rows, F2] with rows >= 1."""
        if self._device.type != 'cuda' or not all(
                isinstance(v, np.ndarray)
                for v in (input_1, input_2a, input_2b)):
            return None
        self._invalidate_stale_pipelines()
        if self._pipeline is None:
            self._pipeline = self._build_pipeline()
        folded = self._pipeline.folded
        if folded is None or self._has_towers():
            return None
        rows, f1, f2 = (input_1.shape[0], folded.rot1.shape[0],
                        folded.rot2.shape[0])
        if not (rows and input_1.shape == (rows, f1)
                and input_2a.shape == input_2b.shape == (rows, f2)):
            return None
        operands = prepared_operands(folded, torch.float32)
        return (rows, f1, f2, operands.pointers), operands, folded

    def infer_pair(self, input_1, input_2a, input_2b, output_a,
                   output_b) -> Tuple[np.ndarray, np.ndarray]:
        """Scores BOTH candidate streams against one brain window; with
        the fused decode, one kernel launch reads input_1 once.
        Value-identical to two infer_one calls.

        Where ``_plan_key`` finds a plan's key seen before, the push
        replays that resident plan (decode/push_plan.py), captured on
        the key's second sight; the scores are the same bits."""
        with profiling.span('decoder.infer_pair'):
            found = self._plan_key(input_1, input_2a, input_2b)
            if found is not None:
                key, operands, folded = found
                plan = self._push_plans.plan(
                    key, operands, lambda: push_plan.PushPlan(
                        folded, operands, *key[:3], self._device))
                if plan is not None:
                    return plan.run(input_1, input_2a, input_2b)
            scores_a, scores_b = self._pair_scores(
                input_1, input_2a, input_2b, output_a, output_b)
            with profiling.span('decoder.copy_out'):
                profiling.host_wait(self._device, 2)
                scores = scores_a.cpu().numpy(), scores_b.cpu().numpy()
            if found is not None:
                self._push_plans.saw(found[0])
            return scores

    def infer_pair_async(self, input_1, input_2a, input_2b, output_a,
                         output_b):
        """infer_pair without waiting for the scores (counterpart of
        telluride_decoding_tpu/decode/infer_decoder.py:669-681).

        On the card it launches what infer_pair launches (one K1 launch
        with the fused decode), issues both device-to-host copies into
        pinned host tensors without blocking, records a CUDA event and
        returns a PendingPair: unpacking it gives two score handles that
        ``np.asarray`` turns into arrays after waiting on the event, and
        ``harvest()`` gives both. On the CPU it returns the two arrays."""
        with profiling.span('decoder.infer_pair'):
            scores = self._pair_scores(input_1, input_2a, input_2b,
                                       output_a, output_b)
            if self._device.type != 'cuda':
                with profiling.span('decoder.copy_out'):
                    return tuple(s.numpy() for s in scores)
            return PendingPair(scores)

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

    def reduce_with_lda(self, d1) -> np.ndarray:
        if self._lda is None:
            raise ValueError('Must compute the LDA model before reducing '
                             'data.')
        if not isinstance(d1, np.ndarray):
            raise TypeError('Input data must be an numpy array, not %s.' %
                            type(d1))
        return self._lda.transform(d1)

    # -- evaluation ---------------------------------------------------------------

    def test_all(self, exp_data) -> Tuple[np.ndarray, np.ndarray]:
        """Decodes a whole dataset; returns (likelihoods, labels)."""
        predictions = result_store.NumpyStore(name='test_all predictions')
        labels = result_store.NumpyStore(name='test_all labels')
        for input_dict, output in exp_data:
            predictions.add_data(self.infer_one(input_dict, output))
            labels.add_data(np.asarray(input_dict['attended_speaker']))
        return predictions.all_data, labels.all_data

    def test_by_window(self, dataset, window_size: int
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields (inference, label) windows of window_size frames,
        advancing by window_size // 2, at least 1 (at window_size 1 the
        reference's zero step would yield one window forever)."""
        storage = result_store.TwoResultStore(
            window_width=window_size,
            window_step=max(window_size // 2, 1))
        for input_dict, output in dataset:
            infer_results = self.infer_one(input_dict, output)
            storage.add_data(infer_results,
                             np.asarray(input_dict['attended_speaker']))
            for r1, r2 in storage.next_window():
                yield r1, r2

    def frame_scores(self, dataset) -> Tuple[np.ndarray, np.ndarray]:
        """Per-frame scores and labels of an in-order dataset, the
        window-size-independent half of test_by_window_means
        (telluride_decoding_tpu/decode/infer_decoder.py:548-594).

        A BrainDataset without batch transforms decodes in one
        ``infer_one`` call over its stored arrays, cut to whole
        minibatches as its iterator would; any other dataset decodes
        batch by batch.
        """
        from telluride_decoding_torch.data.brain_data import BrainDataset
        if isinstance(dataset, BrainDataset) and \
                not dataset.has_batch_transforms:
            in1, in2, out, attended = dataset.all_arrays()
            batch = dataset.batch_size
            if batch:
                keep = (in1.shape[0] // batch) * batch
                in1, in2 = in1[:keep], in2[:keep]
                out, attended = out[:keep], attended[:keep]
            scores = self.infer_one({'input_1': in1, 'input_2': in2}, out)
            labels = np.asarray(attended)
        else:
            scores_parts, label_parts = [], []
            for input_dict, output in dataset:
                scores_parts.append(self.infer_one(input_dict, output))
                label_parts.append(
                    np.asarray(input_dict['attended_speaker']))
            if not scores_parts:
                return np.zeros((0,)), np.zeros((0,))
            scores = np.concatenate(scores_parts)
            labels = np.concatenate(label_parts)
        scores = np.asarray(scores)
        if scores.ndim > 1 and scores.shape[-1] > 1:
            # reduction='all': a window's statistic is the mean over its
            # frames and dims, so averaging the dims first is exact.
            scores = scores.mean(axis=-1)
        scores = np.reshape(scores, (-1,))
        labels = np.reshape(np.asarray(labels)[:, 0] if labels.ndim > 1
                            else labels, (-1,))
        return scores, labels

    @staticmethod
    def window_means(scores: np.ndarray, labels: np.ndarray,
                     window_size: int) -> Tuple[np.ndarray, np.ndarray]:
        """50%-overlap window means over precomputed frame scores."""
        step = max(window_size // 2, 1)
        num_windows = max((scores.shape[0] - window_size) // step + 1, 0)
        if num_windows <= 0:
            return np.zeros((0,)), np.zeros((0,))
        csum_s = np.concatenate([[0.0], np.cumsum(scores)])
        csum_l = np.concatenate([[0.0], np.cumsum(labels)])
        starts = np.arange(num_windows) * step
        mean_scores = (csum_s[starts + window_size] -
                       csum_s[starts]) / window_size
        mean_labels = (csum_l[starts + window_size] -
                       csum_l[starts]) / window_size
        return mean_scores, mean_labels

    def test_by_window_means(self, dataset, window_size: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-window mean scores and labels of an in-order dataset: the
        batched equivalent of averaging each window of test_by_window."""
        scores, labels = self.frame_scores(dataset)
        return self.window_means(scores, labels, window_size)

    def check_model_and_data(self, actual_dataset):
        """Validates a dataset's widths against the loaded model's."""
        if not self.model_inputs or not self.model_output:
            raise ValueError('Model has not been initialized yet. Use '
                             'load_model first')
        for actual_input_dict, actual_output in actual_dataset:
            for key, spec in self.model_inputs.items():
                if key not in actual_input_dict:
                    raise TypeError('Can\'t find needed key %s in '
                                    'input_data (%s)' %
                                    (key, list(actual_input_dict.keys())))
                if actual_input_dict[key].shape[1] != spec[1]:
                    raise TypeError('Data for %s has the wrong shape, '
                                    'expected %s, got %s' %
                                    (key, spec,
                                     actual_input_dict[key].shape))
            if actual_output.shape[1] != self.model_output[1]:
                raise TypeError('Output data has the wrong shape, expected '
                                '%s, got %s' % (self.model_output,
                                                actual_output.shape))
            break


class LinearRegressionDecoder(Decoder):
    """Decoder pairing ground truth with regression predictions."""

    def decode_one(self, input_dict, ground_truth):
        with torch.no_grad():
            predictions = self._decoding_model(
                {k: v for k, v in input_dict.items()
                 if k in ('input_1', 'input_2')}).cpu().numpy()
        return np.asarray(ground_truth), predictions

    def _decode_tensors(self, input_dict, ground_truth):
        return ground_truth, self._decoding_model(input_dict)


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
        """The model's CCA rotations folded with the statistics and LDA.

        For a CCA model they rotate input_1 and input_2. For a deep CCA
        model (one with towers) mean1, mean2, rot1 and rot2
        are the final CCA of the towers' outputs [N, cca_dims], which
        ``_kernel_inputs`` hands to K1 in place of the inputs: the JAX
        decode's apply -> correlate_reduce, one function."""
        params = getattr(self._decoding_model, 'params', None)
        if params is None:
            return None
        return fold_decode_params(dict(
            {k: params[k] for k in ('mean1', 'mean2', 'rot1', 'rot2')},
            corr_mean_x=mean_x, corr_mean_y=mean_y, corr_power=power,
            lda_w=lda_w, lda_slope=lda_slope, lda_intercept=lda_intercept))

    def _kernel_inputs(self, x1, x2s):
        """The inputs, or a deep CCA model's tower outputs (h1 of input_1,
        h2 of each input_2 stream)."""
        if not self._has_towers():
            return x1, x2s
        tower = self._decoding_model.tower
        return tower(1, x1), [tower(2, x2) for x2 in x2s]

    def _has_towers(self):
        return getattr(self._decoding_model, 'tower', None) is not None


def create_decoder(model_tag: str, reduction: str = 'lda', model=None, *,
                   device) -> Decoder:
    """The Decoder subclass for a model directory or tag.

    A model directory's model.json decides (a CCA class gets the CCA
    decoder, any other the linear one). In a reference SavedModel
    directory the checkpoint's keys decide: one holding ``rot1`` gives
    the CCA decoder, one holding ``kernel`` the linear one. Otherwise,
    as for a bare tag, the name decides. As in the JAX package, a
    positional checkpoint (``variables/<n>``) has neither key, so its
    directory's name decides, and any error of the sniff is swallowed.
    """
    meta_path = os.path.join(model_tag, 'model.json')
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            model_class = json.load(f).get('model_class', '')
        if 'CCA' in model_class.upper():
            return CCADecoder(model, reduction=reduction, device=device)
        if model_class:
            return LinearRegressionDecoder(model, reduction=reduction,
                                           device=device)
    if os.path.isfile(os.path.join(model_tag, 'saved_model.pb')):
        try:
            from telluride_decoding_torch.io.tf_checkpoint import (
                read_tensor_bundle)
            tensors = read_tensor_bundle(
                os.path.join(model_tag, 'variables', 'variables'))
            if any('rot1' in k for k in tensors):
                return CCADecoder(model, reduction=reduction, device=device)
            if any('kernel' in k for k in tensors):
                return LinearRegressionDecoder(model, reduction=reduction,
                                               device=device)
        except Exception:  # noqa: BLE001 - the JAX sniff's, kept.
            pass
    tag = model_tag.lower()
    if 'linear' in tag or 'fullyconnected' in tag:
        return LinearRegressionDecoder(model, reduction=reduction,
                                       device=device)
    if 'cca' in tag:
        return CCADecoder(model, reduction=reduction, device=device)
    raise ValueError('Couldn\'t determine model type for tag %s.' %
                     model_tag)


def create_dataset(tfrecord_file: str, params: Dict[str, Any],
                   audio_label: str, frame_rate: int = 100,
                   mode: str = 'test', mixup_batch: bool = False, *,
                   device):
    """A two-speaker test dataset of one TFRecord file: ``audio_label``
    as input_2 and output, in stored order, batches of 200
    (telluride_decoding_tpu/decode/infer_decoder.py:720-742)."""
    from telluride_decoding_torch.data import brain_data
    tf_dir, tf_file = os.path.split(tfrecord_file)
    exp_brain_data = brain_data.TFExampleData(
        params['input_field'],
        audio_label,
        frame_rate,
        pre_context=params['pre_context'],
        post_context=params['post_context'],
        in2_fields=audio_label,
        in2_pre_context=params['input2_pre_context'],
        in2_post_context=params['input2_post_context'],
        attended_field='attended_speaker',
        final_batch_size=200,
        repeat_count=1,
        shuffle_buffer_size=0,
        data_dir=tf_dir,
        data_pattern=tf_file,
        device=device)
    return exp_brain_data.create_dataset(mode, mixup_batch=mixup_batch)
