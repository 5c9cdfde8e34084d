"""VLAAI, a deep convolutional envelope decoder (the port's own; the JAX
package has no twin): Accou, Vanthornhout, Van hamme and Francart,
"Decoding of the speech envelope from EEG using the VLAAI deep neural
network", Scientific Reports 2023, as the public code builds it
(https://github.com/exporl/vlaai, ``vlaai.py``).

E is [T, C] of EEG. ``Conv1D`` is "valid" with stride 1, y[t, o] = b[o] +
sum_{k<K} sum_c h[t + k, c] W[k, c, o]; ``LN`` is layer norm over the
channels with a learned scale and shift and eps 1e-3, and ``LReLU`` leaky
ReLU of slope 0.3 (the Keras defaults the public code leaves unset).

  * The extractor X, one set of weights shared by every block: five
    layers (C -> 256 -> 256 -> 256 -> 128 -> 128 at the published
    widths, kernels 8), each h <- pad_end(LReLU(LN(Conv1D(h)))), K - 1
    zero rows appended after the activation.
  * D_i, a dense layer 128 -> C of block i, one a block.
  * The output context O, shared by every block: O(h) =
    LReLU(LN(Conv1D_{K=32, C -> C}(pad_start(h)))), K - 1 zero rows in
    front: causal.
  * x_0 = 0, x_i = O(D_i(X(E + x_{i-1}))) for i = 1..blocks, then the
    output layer x_blocks W + b.

A block sees its input from 31 frames before to 35 after (the output
context's 31, the extractor's 5 x 7), four blocks from ``pre`` = 124
before to ``post`` = 140 after: the model's ``window_context``. Its
``forward`` takes a raw window of [rows + pre + post, C] frames and
returns the [rows, outputs] predictions of its frames pre .. pre + rows -
1, each of which reads no padding that a forward pass over a longer
window would not read alike: so frame t's prediction is the network on
the frames [t - pre, t + post], and a served stream's rows equal the
forward pass over the whole stream with ``pre`` zero frames in front.
The decoder hands it the serving loop's raw windows unstacked
(``decode/infer_decoder.py``).

Each convolution is an unfold of its input into [rows, K * C_in] columns
(a copy) and one float32 product with the [K * C_in, C_out] weights
(cuBLAS on the card, TF32 off by the device policy): no cuDNN algorithm
search, so for given shapes a forward pass launches the same kernels and
gives the same bits, eagerly or replayed from a push plan's graph.

Parameters, as weights.npz names them (Keras's layouts): ``extractor/j/
{w [K, C_in, C_out], b, gamma, beta}`` for layer j, ``dense/i/{w [128,
C], b}`` for block i, ``context/{w [32, C, C], b, gamma, beta}``,
``output/{w [C, outputs], b}``. Training is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from telluride_decoding_torch.models.brain_model import (BrainModel,
                                                         register_model)

# Keras's LayerNormalization epsilon and LeakyReLU slope, which the
# public code leaves at their defaults.
LN_EPS = 1e-3
SLOPE = 0.3


def conv1d(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """A "valid" convolution of [N, C_in] by [K, C_in, C_out]: [N - K + 1,
    C_out], as unfolded columns times the flattened weights."""
    k, c_in, c_out = w.shape
    n = h.shape[0] - k + 1
    # [n, C_in, K] -> [n, K, C_in]: row t holds frames t .. t + K - 1.
    cols = h.unfold(0, k, 1).transpose(1, 2).reshape(n, k * c_in)
    return torch.addmm(b, cols, w.reshape(k * c_in, c_out))


def activation(h: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(h, SLOPE)


def conv_ln_act(h, params, prefix):
    """LReLU(LN(Conv1D(h))) of the layer named ``prefix``."""
    h = conv1d(h, params[prefix + 'w'], params[prefix + 'b'])
    h = F.layer_norm(h, (h.shape[1],), params[prefix + 'gamma'],
                     params[prefix + 'beta'], LN_EPS)
    return activation(h)


def extractor(params, h: torch.Tensor, layers: int) -> torch.Tensor:
    """The shared extractor: each layer's output padded at its end back
    to the input's length."""
    for j in range(layers):
        k = params['extractor/%d/w' % j].shape[0]
        h = F.pad(conv_ln_act(h, params, 'extractor/%d/' % j),
                  (0, 0, 0, k - 1))
    return h


def output_context(params, h: torch.Tensor) -> torch.Tensor:
    """The shared causal output context: the input padded at its start."""
    k = params['context/w'].shape[0]
    return conv_ln_act(F.pad(h, (0, 0, k - 1, 0)), params, 'context/')


def run_blocks(params, e: torch.Tensor, count: int, layers: int
               ) -> torch.Tensor:
    """x_count: every block reads E plus the block before's output."""
    x = torch.zeros_like(e)
    for i in range(count):
        h = extractor(params, e + x, layers)
        h = torch.addmm(params['dense/%d/b' % i], h,
                        params['dense/%d/w' % i])
        x = output_context(params, h)
    return x


@register_model
class BrainModelVLAAI(BrainModel):
    """The VLAAI network (module docstring) as a port model: ``forward``
    on a raw window, its parameters in a dict under their weights.npz
    names, ``save`` / ``load_model`` as the other classes."""

    loss_name = 'mse'
    metric_names = ('pearson_correlation_first',)
    reads_input_1_only = True

    def __init__(self, input_channels: int = 64,
                 filters: Sequence[int] = (256, 256, 256, 128, 128),
                 kernels: Sequence[int] = (8, 8, 8, 8, 8),
                 context_kernel: int = 32, blocks: int = 4,
                 output_width: int = 1,
                 tensorboard_dir: Optional[str] = None, *, device):
        super().__init__(device, tensorboard_dir)
        if len(filters) != len(kernels) or not filters:
            raise ValueError('VLAAI needs one kernel a filter count, got '
                             '%s and %s.' % (list(filters), list(kernels)))
        self._input_channels = int(input_channels)
        self._filters = [int(f) for f in filters]
        self._kernels = [int(k) for k in kernels]
        self._context_kernel = int(context_kernel)
        self._blocks = int(blocks)
        self._output_width = int(output_width)
        self._params: Optional[Dict[str, torch.Tensor]] = None

    def config(self) -> Dict[str, Any]:
        return {'input_channels': self._input_channels,
                'filters': list(self._filters),
                'kernels': list(self._kernels),
                'context_kernel': self._context_kernel,
                'blocks': self._blocks,
                'output_width': self._output_width}

    @property
    def window_context(self) -> Tuple[int, int]:
        """(pre, post): the frames before and after a frame that its
        prediction reads."""
        return (self._blocks * (self._context_kernel - 1),
                self._blocks * sum(k - 1 for k in self._kernels))

    def param_shapes(self) -> List[Tuple[str, tuple]]:
        c = self._input_channels
        shapes = []
        width = c
        for j, (f, k) in enumerate(zip(self._filters, self._kernels)):
            shapes += [('extractor/%d/w' % j, (k, width, f)),
                       ('extractor/%d/b' % j, (f,)),
                       ('extractor/%d/gamma' % j, (f,)),
                       ('extractor/%d/beta' % j, (f,))]
            width = f
        for i in range(self._blocks):
            shapes += [('dense/%d/w' % i, (width, c)),
                       ('dense/%d/b' % i, (c,))]
        shapes += [('context/w', (self._context_kernel, c, c)),
                   ('context/b', (c,)), ('context/gamma', (c,)),
                   ('context/beta', (c,)),
                   ('output/w', (c, self._output_width)),
                   ('output/b', (self._output_width,))]
        return shapes

    @property
    def params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The parameters by weights.npz name; None before a load."""
        return self._params

    def set_params(self, values: Dict[str, torch.Tensor]):
        want = dict(self.param_shapes())
        got = {k: tuple(np.shape(values[k])) for k in want if k in values}
        if got != want:
            raise ValueError('Weights of shapes %s do not fit a VLAAI of '
                             'config %s.' % (got, self.config()))
        self._params = {name: torch.as_tensor(values[name]).detach().to(
            self.device, torch.float32).contiguous() for name in want}
        self.params_version += 1

    def _restore_params(self, flat: Dict[str, np.ndarray]):
        if not flat:
            self._params = None
            self.params_version += 1
            return
        missing = [k for k, _ in self.param_shapes() if k not in flat]
        if missing:
            raise ValueError(
                'Checkpoint is missing weight %r (has %s); was it saved by '
                'an incompatible model config?' % (missing[0], sorted(flat)))
        self.set_params({k: torch.from_numpy(np.array(flat[k], np.float32))
                         for k, _ in self.param_shapes()})

    @classmethod
    def from_numpy(cls, flat: Dict[str, np.ndarray], device,
                   config: Optional[dict] = None) -> 'BrainModelVLAAI':
        """The model of constructor ``config`` (the published widths
        without one) on ``device``, holding the flat dict's weights."""
        model = cls(**(config or {}), device=device)
        model._restore_params(flat)
        return model

    def forward(self, input_dict) -> torch.Tensor:
        """[rows + pre + post, C] raw frames -> [rows, outputs]."""
        params = self._params
        if params is None:
            raise ValueError('Model must be loaded before calling.')
        e = self.as_tensor(input_dict['input_1']).float()
        pre, post = self.window_context
        if e.dim() != 2 or e.shape[1] != self._input_channels or \
                e.shape[0] <= pre + post:
            raise ValueError(
                'VLAAI takes a raw window of [rows + %d, %d] frames (its '
                'context: %d before a frame, %d after), got %s.'
                % (pre + post, self._input_channels, pre, post,
                   tuple(e.shape)))
        x = run_blocks(params, e, self._blocks, len(self._filters))
        x = x[pre:e.shape[0] - post]
        return torch.addmm(params['output/b'], x, params['output/w'])
