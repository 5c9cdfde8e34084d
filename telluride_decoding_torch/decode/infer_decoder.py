"""Attention decoding: correlation state + reductions + LDA (port of
decode/infer_decoder.py:38-742).

The per-window serving path of a CCA model with the LDA reduction
(``infer_one``/``infer_pair``) is one launch of kernel K1 per call:
rotate both inputs, form the normalized correlation, project through the
LDA, one score per frame (windows of T = 1). For a deep CCA model K1 runs
on the towers' outputs (a served chunk's towers in one launch of kernel
T1; larger calls through plain matrix products, bias adds and ReLUs),
with the model's final CCA as its rotations. ``infer_pair``
scores both audio streams against one read of the brain window. The
serving loop's pushes bring raw context windows (``LagRows``): the
decoder uploads their frames and stacks them where it uses them, with
K2 on the card. One method, ``Decoder._scores_on``, composes a call
(lag stack, towers, K1) on every route; on the card, a push of host
arrays or raw windows whose shape was seen before replays a resident
push plan (decode/push_plan.py) that captured it: one copy in, that
composition and one copy out as one CUDA graph, and one wait.
``frame_scores`` scores a whole test split in one ``infer_one`` call, so
its K1 launch covers every frame of the split. The other reductions, and
the regression decoders, run as plain torch, as ``_reduce`` does in the
JAX package: a regression model whose prediction reads input_1 alone
(the linear and fullyconnected regressors) predicts once a call, and
each talker's envelope is correlated with that prediction (a served
chunk's prediction, correlations and LDA in one launch of kernel R1
where the prediction is a dense ReLU stack and the reduction 'lda');
such a decoder's pushes ride a push plan too, its envelopes staged
beside the frames. A model with a window context (VLAAI,
models/vlaai.py) reads input_1's raw window [rows + pre + post, C]
itself, unstacked, and predicts its rows: the route of a regression
model with no K2 for the EEG, chosen once when the pipeline is built;
such a model is served only (the offline routes, which read stacked
rows, refuse it).

``decoder_model.json`` stays wire-compatible with the JAX package and the
reference: the same ModelParams namedtuple structure, complex arrays
split re/im (NumpyEncoder).
"""

from __future__ import annotations

import collections
import json
import os
import weakref
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

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
from telluride_decoding_torch.ops.lagstack import LagRows, lag_stack
from telluride_decoding_torch.ops.regression_push import (RegressionWeights,
                                                          regression_push)
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


class _Pipeline(collections.namedtuple(
        '_Pipeline', ['folded', 'towers', 'correlate_reduce',
                      'regression', 'window', 'input_1'])):
    """What a decoder serves with, built from the current model and
    statistics: ``folded`` (kernel K1's parameters) and ``towers`` (a
    deep CCA model's ``Decoder._towers()``, which holds the weights it
    reads, or None) when the fused decode applies, else None and None
    and ``correlate_reduce(r1, r2)`` in plain torch; ``regression``,
    a regression decoder's layers, statistics and LDA for kernel R1
    (``RegressionWeights``, packed once on the card) where its
    prediction is a dense ReLU stack and the reduction 'lda', else
    None; ``window``, the model's window context (pre, post) where it
    reads a raw window (``BrainModel.window_context``), else None; and
    ``input_1(frames, lags)``, what the model reads of input_1: its
    rows, stacked where it has context (``_stacked``), or for a window
    model the raw window itself (``_raw_window``)."""


def _frames(value):
    """A LagRows' raw frames; any other input is its own."""
    return value.frames if isinstance(value, LagRows) else value


def _lags(value) -> Tuple[int, int]:
    """A LagRows' (pre, post); (0, 0) for any other input."""
    return (value.pre, value.post) if isinstance(value, LagRows) else (0, 0)


def _rows(frames, lags) -> int:
    """The rows a call scores: input_1's frames less its context."""
    return frames[0].shape[0] - sum(lags[0])


def _stacked(x: torch.Tensor, lags: Tuple[int, int]) -> torch.Tensor:
    """A stream's rows from its frames on the decoder's device: lag
    stacked where it has context (K2 on the card; on the CPU the plain
    stack), row t the row of frame pre + t: a copy, the host stack's
    bits."""
    pre, post = lags
    if not pre + post:
        return x
    return lag_stack(x, 0, pre + post)[:len(x) - pre - post]


def _raw_window(context: Tuple[int, int]) -> Callable:
    """input_1 of a model with a window context: the raw window [rows +
    pre + post, C] as the serving loop's LagRows holds it, unstacked."""
    def raw_window(x: torch.Tensor, lags: Tuple[int, int]) -> torch.Tensor:
        if tuple(lags) != tuple(context):
            raise ValueError(
                'A model with a window context of %s reads raw windows of '
                'that context (ops/lagstack.py::LagRows, as '
                'cli/serve.py::StreamingAttentionServer.push hands them '
                'over), not inputs of context %s.' % (context, tuple(lags)))
        return x
    return raw_window


class PairProgram(torch.nn.Module):
    """A decoder's two-stream program ``(input_1, input_2a, input_2b,
    output_a, output_b) -> (scores_a, scores_b)``, built from
    ``Decoder._build_pipeline`` with the statistics, the LDA and the
    model's weights as constants: what decode/aot.py exports.

    It makes the split ``Decoder._scores_on`` makes. Where the fused
    decode applies (a CCA or deep CCA model with the LDA reduction) it
    runs the towers of a deep CCA model as the model's own stack (its
    ``plain`` towers: no kernel T1, whose choice by row count would not
    hold over the exported dynamic frame axis), then one op
    ``tdt::fused_cca_decode_f32``
    (kernel K1 on the card) over both streams, on K1's operands held as
    buffers; otherwise ``_decode_tensors`` and ``correlate_reduce`` per
    stream in plain torch (the model's stack: never kernel R1, for the
    same reason).
    """

    def __init__(self, decoder: 'Decoder'):
        super().__init__()
        decoder.require_stacked_rows('An AOT program (PairProgram), which '
                                     'takes stacked rows,')
        self._decoder = decoder
        # A submodule, so the model's buffers are the program's.
        self.model = decoder.decoding_model
        self._dims = 0
        pipeline = decoder._build_pipeline()
        folded, towers = pipeline.folded, pipeline.towers
        self._correlate_reduce = pipeline.correlate_reduce
        self._towers = None if towers is None else towers.plain
        if folded is not None:
            self._dims = int(folded.rot1.shape[1])
            for name, tensor in zip(('rot1', 'rot2', 'consts'),
                                    kernel_operands(folded)):
                self.register_buffer(name, tensor)

    def forward(self, input_1, input_2a, input_2b, output_a, output_b):
        decoder = self._decoder
        if self._dims:
            x1, (x2a, x2b) = decoder._kernel_inputs(
                self._towers, input_1, [input_2a, input_2b])
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

    def _kernel_inputs(self, towers: Optional[Callable], x1: torch.Tensor,
                       x2s: List[torch.Tensor]
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """What kernel K1 rotates: the inputs themselves, or the outputs
        of a pipeline's ``towers`` on them (span ``decoder.towers``)."""
        if towers is None:
            return x1, x2s
        with profiling.span('decoder.towers'):
            return towers(x1, x2s)

    def _towers(self) -> Optional[Callable]:
        """The towers the inputs pass before K1, as a function
        ``(x1, x2s) -> (h1, h2s)`` holding the weights it reads; None
        where K1 rotates the inputs themselves."""
        return None

    def _input_widths(self, folded: FoldedDecode) -> Tuple[int, int]:
        """(F1, F2) of the inputs a call with ``folded`` takes."""
        return folded.rot1.shape[0], folded.rot2.shape[0]

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
            regression = (None if folded is not None else
                          self._regression(mean_x, mean_y, power, lda_w,
                                           lda_slope, lda_intercept))
        else:
            lda_w, lda_slope, lda_intercept, folded = None, 0.0, 0.0, None
            regression = None

        def correlate_reduce(r1, r2):
            correlations = (r1 - mean_x) * (r2 - mean_y) / power
            return _reduce(correlations, reduction, lda_w, lda_slope,
                           lda_intercept)
        window = self._window_context()
        return _Pipeline(folded, None if folded is None else self._towers(),
                         correlate_reduce, regression, window,
                         _stacked if window is None else _raw_window(window))

    def _window_context(self) -> Optional[Tuple[int, int]]:
        """The decoding model's window context (pre, post), or None."""
        return getattr(self._decoding_model, 'window_context', None)

    def require_stacked_rows(self, what: str):
        """Refuses ``what``, an offline route that reads lag-stacked
        rows, for a model with a window context: its rows would stack
        pre + 1 + post lags of every frame, and it reads raw windows
        (``infer_one`` and the routes through it refuse such rows in
        ``_raw_window``)."""
        context = self._window_context()
        if context is not None:
            raise ValueError(
                '%s reads a raw window of %d frames before and %d after '
                'each frame, and is served only through '
                'cli/serve.py::StreamingAttentionServer.push (its '
                'infer_pair on raw windows); %s would stack %d lags of '
                'every frame and is not supported for it.'
                % (type(self._decoding_model).__name__, context[0],
                   context[1], what, sum(context) + 1))

    def _regression(self, mean_x, mean_y, power, lda_w, lda_slope,
                    lda_intercept) -> Optional[RegressionWeights]:
        """Kernel R1's layers and statistics where it applies (a
        regression decoder with the LDA reduction); None here."""
        del mean_x, mean_y, power, lda_w, lda_slope, lda_intercept
        return None

    @staticmethod
    def _fused_prediction(pipeline: _Pipeline, rows: int) -> bool:
        """Whether a call of ``rows`` rows without K1 runs kernel R1:
        the pipeline's layers are packed on the card and R1 takes the
        rows."""
        return (pipeline.regression is not None
                and pipeline.regression.launches(rows))

    def _current_pipeline(self) -> _Pipeline:
        """The cached pipeline, built anew when the model was refit or
        replaced (its tensors derive from the model's parameters)."""
        model = self._decoding_model
        key = (id(model), getattr(model, 'params_version', None))
        if key != self._built_key:
            self._built_key = key
            self._pipeline = None
        if self._pipeline is None:
            self._pipeline = self._build_pipeline()
        return self._pipeline

    @torch.no_grad()
    def _scores_on(self, pipeline: _Pipeline,
                   frames: Sequence[torch.Tensor],
                   lags: Sequence[Tuple[int, int]], outputs=()):
        """The scores of input_1 against each input_2 stream, from each
        stream's frames on this decoder's device and its (pre, post):
        K1's [streams, rows], or a list of each stream's scores. Every
        route of a served call runs this; a push plan captures it.

        A stream with context is lag-stacked (K2 on the card; on the CPU
        the plain stack), row t the row of frame pre + t: a copy, the
        host stack's bits. Then a deep CCA model's towers and kernel K1,
        or, for a pipeline without K1, the model's predictions
        (``_decode_streams``) and ``correlate_reduce`` against each
        stream's output, ``outputs`` on this decoder's device: [streams,
        rows] (or [streams, rows, D] for 'all'); where
        ``_fused_prediction`` holds, kernel R1 computes that in one
        launch (span ``decoder.predict``). A model with a window context
        reads input_1's raw window instead (``pipeline.input_1``)."""
        x1 = pipeline.input_1(frames[0], lags[0])
        x2s = [_stacked(x, lag) for x, lag in zip(frames[1:], lags[1:])]
        if pipeline.folded is None:
            if self._fused_prediction(pipeline, len(x1)):
                with profiling.span('decoder.predict'):
                    return regression_push(pipeline.regression, x1,
                                           outputs)
            return torch.stack([
                pipeline.correlate_reduce(r1, r2)
                for r1, r2 in self._decode_streams(x1, x2s, outputs)])
        x1, x2s = self._kernel_inputs(pipeline.towers, x1, x2s)
        # Kernel K1, per-frame scores: windows of one frame.
        scores = fused_cca_decode(
            pipeline.folded, x1[:, None, :], x2s[0][:, None, :],
            x2s[1][:, None, :] if len(x2s) > 1 else None)
        return scores if len(x2s) > 1 else scores[None]

    def _decode_streams(self, x1: torch.Tensor, x2s: List[torch.Tensor],
                        outputs: Sequence[torch.Tensor]
                        ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """(r1, r2) of each input_2 stream against input_1 and the
        stream's output: the model's forward passes (span
        ``decoder.predict``), one a stream."""
        with profiling.span('decoder.predict'):
            return [self._decode_tensors({'input_1': x1, 'input_2': x2}, y)
                    for x2, y in zip(x2s, outputs)]

    def _shares_prediction(self) -> bool:
        """Whether one forward pass of the model serves every input_2
        stream of a call without K1 (``LinearRegressionDecoder``)."""
        return False

    def _upload(self, pipeline: _Pipeline, inputs, outputs=()):
        """Each input's frames on this decoder's device, its lags, and
        for a pipeline without K1 the outputs on the device (K1 reads
        none)."""
        return ([self._tensor(_frames(v)) for v in inputs],
                [_lags(v) for v in inputs],
                [] if pipeline.folded is not None else
                [self._tensor(y) for y in outputs])

    def _count_served(self, pipeline: _Pipeline, lags, rows: int):
        """Counts what one call of ``rows`` rows a stream served, while a
        profiler runs: a deep CCA model's tower passes, one a stream, and
        those of them that ran kernel T1 (towers that tell, by ``fused``);
        without K1, the model's forward passes, and those of them that
        ran kernel R1, and for a model with a window context the raw
        frames they read (input_1's rows and context, not stacked); on the
        card, one device stack where a stacked stream had context."""
        if pipeline.folded is None:
            passes = 1 if self._shares_prediction() else len(lags) - 1
            profiling.count(profiling.PREDICT_PASSES, passes)
            if self._fused_prediction(pipeline, rows):
                profiling.count(profiling.FUSED_PREDICT_PASSES, passes)
            if pipeline.window is not None:
                profiling.count(profiling.WINDOW_FRAMES,
                                passes * (rows + sum(pipeline.window)))
                lags = lags[1:]
        towers = pipeline.towers
        if towers is not None:
            profiling.count(profiling.TOWER_PASSES, len(lags))
            fused = getattr(towers, 'fused', None)
            if fused is not None and fused(rows):
                profiling.count(profiling.FUSED_TOWER_PASSES, len(lags))
        if self._device.type == 'cuda' and any(map(sum, lags)):
            profiling.count(profiling.DEVICE_STACKS)

    def infer_one(self, input_dict, output) -> np.ndarray:
        """Scores of one minibatch: [N] (or [N, D] for 'all')."""
        pipeline = self._current_pipeline()
        frames, lags, outputs = self._upload(
            pipeline, (input_dict['input_1'], input_dict['input_2']),
            [output])
        (scores,) = self._scores_on(pipeline, frames, lags, outputs)
        self._count_served(pipeline, lags, _rows(frames, lags))
        return scores.cpu().numpy()

    def _pair_scores(self, input_1, input_2a, input_2b, output_a,
                     output_b):
        pipeline = self._current_pipeline()
        with profiling.span('decoder.copy_in'):
            frames, lags, outputs = self._upload(
                pipeline, (input_1, input_2a, input_2b), (output_a, output_b))
        with profiling.span('decoder.launch'):
            scores = self._scores_on(pipeline, frames, lags, outputs)
        self._count_served(pipeline, lags, _rows(frames, lags))
        return scores

    def _plan_key(self, input_1, input_2a, input_2b, *outputs):
        """(pipeline, rows, each stream's (pre, post)): the key of the
        resident push plan for these inputs, or None where the plan does
        not apply: a decoder off the card, inputs that are not all numpy
        arrays or all LagRows (raw windows, the two audio windows alike)
        of rows >= 1, or a pipeline served by neither kernel K1 (a CCA or
        deep CCA model with the LDA reduction, inputs of [rows, F1] and
        [rows, F2]; a deep CCA model's F1 and F2 are its towers' input
        widths) nor ``_outputs_key`` (a regression decoder, which adds
        the widths of its inputs and ``outputs``). A host array is a
        window with no context. A refit, a ``set_params`` or new
        statistics build a new pipeline, so a new key."""
        if self._device.type != 'cuda':
            return None
        inputs = (input_1, input_2a, input_2b)
        if not (all(isinstance(v, np.ndarray) and v.ndim == 2
                    for v in inputs)
                or all(isinstance(v, LagRows) for v in inputs)):
            return None
        lags = tuple(_lags(v) for v in inputs)
        (rows, f1), shape_2a, shape_2b = (v.shape for v in inputs)
        if (lags[1] != lags[2] or not rows or shape_2a != shape_2b
                or shape_2a[0] != rows):
            return None
        pipeline = self._current_pipeline()
        if pipeline.folded is None:
            return self._outputs_key(pipeline, rows, lags,
                                     (f1, shape_2a[1]), outputs)
        if (f1, shape_2a[1]) != self._input_widths(pipeline.folded):
            return None
        return pipeline, rows, lags

    def _outputs_key(self, pipeline: _Pipeline, rows: int, lags, widths,
                     outputs) -> Optional[tuple]:
        """The plan key of a pipeline without K1, which also stages the
        ``outputs`` it correlates with; None here: only a regression
        decoder's pipeline without K1 rides a plan."""
        del pipeline, rows, lags, widths, outputs
        return None

    def _capture(self, key, inputs, outputs) -> push_plan.PushPlan:
        """The push plan of ``key``: ``_scores_on`` of its pipeline and
        lags on frames of the inputs' shapes (and, without K1, on
        ``outputs`` of their shapes, staged after the frames), as a
        function that holds what the graph reads (the pipeline; K1's
        operands, which prepared_operands' LRU may drop; a model's
        parameters, which a refit replaces) and the decoder weakly (a
        cycle would leave the graphs to the cyclic collector, which may
        free them inside another capture and so break it)."""
        pipeline, rows, lags = key[:3]
        held = (getattr(self._decoding_model, 'params', None)
                if pipeline.folded is None else
                prepared_operands(pipeline.folded, torch.float32))
        decoder = weakref.proxy(self)
        streams = len(inputs)
        return push_plan.PushPlan(
            lambda staged, held=held: decoder._scores_on(
                pipeline, staged[:streams], lags, staged[streams:]),
            [_frames(v).shape for v in inputs] + [y.shape for y in outputs],
            rows, self._device)

    def infer_pair(self, input_1, input_2a, input_2b, output_a,
                   output_b) -> Tuple[np.ndarray, np.ndarray]:
        """Scores BOTH candidate streams against one brain window; with
        the fused decode, one kernel launch reads input_1 once.
        Value-identical to two infer_one calls.

        Where ``_plan_key`` finds a plan's key seen before, the push
        replays that resident plan (decode/push_plan.py), captured on
        the key's second sight; the scores are the same bits."""
        with profiling.span('decoder.infer_pair'):
            key = self._plan_key(input_1, input_2a, input_2b, output_a,
                                 output_b)
            if key is not None:
                inputs = (input_1, input_2a, input_2b)
                outputs = ((output_a, output_b) if key[0].folded is None
                           else ())
                plan = self._push_plans.plan(
                    key, lambda: self._capture(key, inputs, outputs))
                if plan is not None:
                    scores = plan.run([_frames(v) for v in inputs] +
                                      list(outputs))
                    self._count_served(key[0], key[2], key[1])
                    return scores
            scores_a, scores_b = self._pair_scores(
                input_1, input_2a, input_2b, output_a, output_b)
            with profiling.span('decoder.copy_out'):
                profiling.host_wait(self._device, 2)
                scores = scores_a.cpu().numpy(), scores_b.cpu().numpy()
            if key is not None:
                self._push_plans.saw(key)
            return scores

    def infer_pair_async(self, input_1, input_2a, input_2b, output_a,
                         output_b):
        """infer_pair without waiting for the scores (counterpart of
        telluride_decoding_tpu/decode/infer_decoder.py:669-681).

        On the card it launches what infer_pair launches without a plan
        (with the fused decode, one K1 launch after the lag stacks),
        issues both device-to-host copies into pinned host tensors
        without blocking, records a CUDA event and returns a PendingPair:
        unpacking it gives two score handles that ``np.asarray`` turns
        into arrays after waiting on the event, and ``harvest()`` gives
        both. On the CPU it returns the two arrays."""
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
        self.require_stacked_rows('Decoder.train')
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
        batch by batch. A model with a window context is refused
        (``require_stacked_rows``): its whole-split evaluation is not
        ported.
        """
        self.require_stacked_rows('Decoder.frame_scores (whole-split '
                                  'evaluation)')
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
    """Decoder pairing ground truth with regression predictions.

    A model that reads input_1 alone (``reads_input_1_only``: the linear
    and fullyconnected regressors) predicts once a call for every
    stream; a model that reads input_2 too (the classifier) once a
    stream. On the card a synchronous push of host arrays or raw windows
    with a reduction of one score a frame rides a push plan, which
    stages the two envelopes beside the frames.

    Where the model's prediction is a dense ReLU stack (its
    ``dense_layers()``: the fullyconnected regressor without batch norm,
    the linear regressor) and the reduction 'lda', the pipeline packs
    its layers, the statistics and the LDA for kernel R1 once
    (``ops/regression_push.py``); a call of at most
    ``regression_push.MAX_ROWS`` rows on the card is then one launch of
    R1 for every stream. Every other call (the CPU, whole test splits,
    batch norm, the classifier, other reductions, wider layers, the AOT
    ``PairProgram``) runs the model's stack and ``correlate_reduce``."""

    def _shares_prediction(self):
        return bool(getattr(self._decoding_model, 'reads_input_1_only',
                            False))

    def _regression(self, mean_x, mean_y, power, lda_w, lda_slope,
                    lda_intercept):
        """R1's RegressionWeights of the model's ``dense_layers()``,
        where its prediction is such a stack (of input_1 alone)."""
        dense_layers = getattr(self._decoding_model, 'dense_layers', None)
        layers = None if dense_layers is None else dense_layers()
        if layers is None:
            return None
        return RegressionWeights(layers, mean_x, mean_y, power, lda_w,
                                 lda_slope, lda_intercept)

    def _decode_streams(self, x1, x2s, outputs):
        """One prediction for every stream's output, where the model's
        prediction reads input_1 alone."""
        if not self._shares_prediction():
            return super()._decode_streams(x1, x2s, outputs)
        with profiling.span('decoder.predict'):
            prediction = self._decoding_model({'input_1': x1})
        return [(y, prediction) for y in outputs]

    def _outputs_key(self, pipeline, rows, lags, widths, outputs):
        """(pipeline, rows, lags, (F1, F2, the outputs' width)) where the
        reduction gives one score a frame (any but 'all') and the two
        outputs are host arrays of [rows, width]."""
        if (self._reduction == 'all' or len(outputs) != 2
                or not all(isinstance(y, np.ndarray) and y.ndim == 2
                           and y.shape == outputs[0].shape
                           for y in outputs)
                or outputs[0].shape[0] != rows):
            return None
        return pipeline, rows, lags, widths + (outputs[0].shape[1],)

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

    def _towers(self):
        """A deep CCA model's towers (h1 of input_1, h2 of each input_2
        stream: ``BrainModelDCCA.towers``), or None."""
        towers = getattr(self._decoding_model, 'towers', None)
        return None if towers is None else towers()

    def _input_widths(self, folded):
        if getattr(self._decoding_model, 'input_widths', None) is None:
            return super()._input_widths(folded)
        return self._decoding_model.input_widths()


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
