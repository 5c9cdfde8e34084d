"""Deterministic linear CCA model (port of BrainModelCCA, models/cca.py:31-135)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from telluride_decoding_torch.models.brain_model import (BrainModel,
                                                         dataset_arrays,
                                                         register_model)
from telluride_decoding_torch.ops.covariance import MomentStats
from telluride_decoding_torch.solvers import cca as cca_solver


@register_model
class BrainModelCCA(BrainModel):
    """Rotates both inputs to maximal correlation.

    ``forward`` concatenates the two rotated streams (the reference
    BrainCcaLayer.call contract), so downstream reductions split the
    output in half. Buffers: mean1 [1, F1], mean2 [1, F2], rot1 [F1, D],
    rot2 [F2, D].
    """

    loss_name = 'cca_pearson_correlation_first'
    metric_names = ('cca_pearson_correlation_first',)
    param_names = ('mean1', 'mean2', 'rot1', 'rot2')

    def __init__(self, input_dataset=None, cca_dims: int = 5,
                 regularization_lambda: float = 0.0,
                 tensorboard_dir: Optional[str] = None,
                 input1_width: Optional[int] = None,
                 input2_width: Optional[int] = None, *, device):
        super().__init__(device, tensorboard_dir)
        if input_dataset is not None:
            spec_in, _ = input_dataset.element_spec
            input1_width = spec_in['input_1'][-1]
            input2_width = spec_in['input_2'][-1]
        if input1_width is not None and input1_width <= 1:
            raise ValueError('Input 1 feature width (%d) should not be <= 1.'
                             % input1_width)
        if input2_width is not None and input2_width <= 1:
            raise ValueError('Input 2 feature width (%d) should not be <= 1.'
                             % input2_width)
        self._input1_width = input1_width
        self._input2_width = input2_width
        self._cca_dims = cca_dims
        self._regularization_lambda = regularization_lambda

    def config(self):
        return {'cca_dims': self._cca_dims,
                'regularization_lambda': self._regularization_lambda,
                'input1_width': self._input1_width,
                'input2_width': self._input2_width}

    @classmethod
    def from_numpy(cls, flat: Dict[str, np.ndarray], device,
                   config: Optional[dict] = None) -> 'BrainModelCCA':
        from telluride_decoding_torch.models.convert import (
            cca_params_from_numpy)
        return cca_params_from_numpy(flat, device, config)

    def _real_dims(self, width1: int, width2: int) -> int:
        return min(width1, width2, self._cca_dims)

    def _note_widths(self, width1: int, width2: int):
        if (self._input1_width, self._input2_width) == (None, None):
            self._input1_width, self._input2_width = width1, width2
        elif (self._input1_width, self._input2_width) != (width1, width2):
            raise ValueError('Model widths %s do not match the data %s.'
                             % ((self._input1_width, self._input2_width),
                                (width1, width2)))

    def forward(self, input_dict) -> torch.Tensor:
        """[N, F1], [N, F2] -> [N, 2D]: (x1 - mean1) @ rot1 | (x2 - mean2) @ rot2.

        Bias-folded, as the JAX apply: x @ R - m @ R, with R rounded to
        x's float dtype and the product taken in float32.
        """
        if self.params is None:
            raise ValueError('Model must be fit or loaded before calling.')

        def rotate(x, mean, rot):
            x = self.as_tensor(x)
            return x.float() @ rot.to(x.dtype).float() - mean @ rot
        r1 = rotate(input_dict['input_1'], self.mean1, self.rot1)
        r2 = rotate(input_dict['input_2'], self.mean2, self.rot2)
        return torch.cat([r1, r2], dim=1)

    def fit(self, dataset, epochs: int = 1, **kwargs) -> dict:
        """Fit from a BrainDataset (its whole arrays) or an iterable of
        (input_dict, output) minibatches of lag-stacked inputs: one
        covariance pass + whitening + SVD."""
        del epochs, kwargs  # Deterministic: one covariance pass + SVD.
        in1, in2, _, _ = dataset_arrays(dataset)
        self._note_widths(in1.shape[1], in2.shape[1])
        solution = cca_solver.calculate_cca_parameters(
            torch.as_tensor(in1, device=self.device),
            torch.as_tensor(in2, device=self.device),
            dim=self._real_dims(in1.shape[1], in2.shape[1]),
            regularization=self._regularization_lambda)
        self._set_solution(solution)
        return {}

    def fit_streaming(self, brain_data, mode: str = 'train', epochs: int = 1,
                      **kwargs) -> dict:
        """Bounded-memory fit from a BrainData source: per-file streamed
        moments of the (input_1, input_2) pair, each file lag stacked on
        the device (kernel K2 on CUDA) with context that never crosses a
        file boundary, then one whitening + SVD solve. Counterpart of
        fit_streaming (telluride_decoding_tpu/models/cca.py:114-126)."""
        del epochs, kwargs  # Deterministic: one covariance pass + SVD.
        total = brain_data.streaming_moments(mode, y_source='input_2',
                                             want_syy=True)
        total = MomentStats(*(t.to(self.device) for t in total))
        width1 = total.sum_x.shape[0]
        width2 = total.sum_y.shape[0]
        self._note_widths(width1, width2)
        solution = cca_solver.solve_cca_from_moments(
            total, dim=self._real_dims(width1, width2),
            regularization=self._regularization_lambda)
        self._set_solution(solution)
        return {}

    def _set_solution(self, solution: cca_solver.CcaSolution):
        self.set_params({'mean1': solution.mean_x, 'mean2': solution.mean_y,
                         'rot1': solution.rot_x, 'rot2': solution.rot_y})
        self.eigenvalues = solution.eigenvalues.cpu().numpy()
