"""CCA brain models (port of models/cca.py): the deterministic linear
CCA and the deep CCA (DCCA), two ReLU towers trained on the deep-CCA
objective with a closed-form CCA of their outputs on top."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from telluride_decoding_torch import device as device_policy
from telluride_decoding_torch.models.brain_model import (BrainModel,
                                                         _SgdModel,
                                                         _apply_mlp,
                                                         _init_mlp,
                                                         _mlp_keys,
                                                         dataset_arrays,
                                                         register_model)
from telluride_decoding_torch.ops import dcca_towers
from telluride_decoding_torch.ops.covariance import (MomentStats,
                                                     moments_from_arrays,
                                                     pad_to_bucket)
from telluride_decoding_torch.parallel import mesh as mesh_lib
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


class DccaTowers:
    """Both towers of one parameter set of a deep CCA model, as a
    function ``(x1, [x2, ...]) -> (h1, [h2, ...])`` computing what
    ``BrainModelDCCA.tower`` computes. It holds those parameters, and
    their copy packed for kernel T1 (``ops/dcca_towers.py``): a refit
    replaces them, so a CUDA graph captured through it keeps reading the
    weights it was captured with, alive at their addresses.

    It adapts by shape: a call of at most ``dcca_towers.MAX_ROWS`` rows a
    stream with the weights packed on the card (``fused``) is one launch
    of T1; every other call (the CPU, evaluation over whole splits,
    widths beyond T1's) runs the model's own stack, ``_apply_mlp``, one
    product, bias add and ReLU at a time (``plain``).
    """

    def __init__(self, model: 'BrainModelDCCA',
                 params: Dict[str, torch.Tensor]):
        self._model = model
        self._params = params
        depth = len(model._hidden) + 1
        self.weights = dcca_towers.TowerWeights(*(
            [(params['tower%d/%d/w' % (index, i)],
              params['tower%d/%d/b' % (index, i)]) for i in range(depth)]
            for index in (1, 2)))

    def fused(self, rows: int) -> bool:
        """Whether a call of ``rows`` rows a stream runs kernel T1."""
        return self.weights.launches(rows)

    def plain(self, x1, x2s) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The model's own stack on each stream."""
        model, params = self._model, self._params
        return (model._tower(params, 1, model.as_tensor(x1).float()),
                [model._tower(params, 2, model.as_tensor(x2).float())
                 for x2 in x2s])

    def __call__(self, x1, x2s) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        if not self.fused(x1.shape[0]):
            return self.plain(x1, x2s)
        model = self._model
        return dcca_towers.dcca_towers(
            self.weights, model.as_tensor(x1).float(),
            [model.as_tensor(x2).float() for x2 in x2s])


@register_model
class BrainModelDCCA(_SgdModel):
    """Deep CCA (JAX models/cca.py:138-280): two MLP towers trained to
    maximise the sum of canonical correlations (``cca_loss``); after the
    SGD fit a closed-form CCA is solved on the tower outputs, so
    ``forward`` returns concatenated canonical signals [r1, r2] as
    BrainModelCCA does.

    Parameters: tower1/i/{b, w} and tower2/i/{b, w} (ReLU hidden
    layers, a linear last layer of cca_dims), and the final CCA's
    mean1, mean2 [1, cca_dims] and rot1, rot2 [cca_dims, cca_dims],
    which rotate the tower outputs, not the inputs.
    """

    loss_name = 'cca_pearson_correlation_first'
    metric_names = ('cca_pearson_correlation_first',)

    def __init__(self, input_dataset=None, cca_dims: int = 5,
                 hidden_units: Optional[List[int]] = None,
                 regularization_lambda: float = 1e-4,
                 tensorboard_dir: Optional[str] = None,
                 input1_width: Optional[int] = None,
                 input2_width: Optional[int] = None, *, device):
        super().__init__(device, tensorboard_dir)
        if hidden_units is None:
            hidden_units = [128, 64]
        if input_dataset is not None:
            spec_in, _ = input_dataset.element_spec
            input1_width = spec_in['input_1'][-1]
            input2_width = spec_in['input_2'][-1]
        self._input1_width = input1_width
        self._input2_width = input2_width
        self._cca_dims = cca_dims
        self._hidden = list(hidden_units)
        self._reg = regularization_lambda

    def config(self):
        return {'cca_dims': self._cca_dims, 'hidden_units': self._hidden,
                'regularization_lambda': self._reg,
                'input1_width': self._input1_width,
                'input2_width': self._input2_width}

    def _tower_widths(self, input_width: int) -> List[int]:
        return [input_width] + self._hidden + [self._cca_dims]

    def param_shapes(self):
        dims = self._cca_dims
        return ([('mean1', (1, dims)), ('mean2', (1, dims)),
                 ('rot1', (dims, dims)), ('rot2', (dims, dims))] +
                _mlp_keys(self._tower_widths(self._input1_width),
                          'tower1/') +
                _mlp_keys(self._tower_widths(self._input2_width),
                          'tower2/'))

    def _init_params(self, gen):
        dims = self._cca_dims
        # The final CCA is the identity until the fit solves it.
        params = {'mean1': torch.zeros((1, dims)),
                  'mean2': torch.zeros((1, dims)),
                  'rot1': torch.eye(dims), 'rot2': torch.eye(dims)}
        params.update(_init_mlp(
            gen, self._tower_widths(self._input1_width), 'tower1/'))
        params.update(_init_mlp(
            gen, self._tower_widths(self._input2_width), 'tower2/'))
        return params

    def _tower(self, params, index: int, x: torch.Tensor) -> torch.Tensor:
        return _apply_mlp(params, x, len(self._hidden) + 1,
                          'tower%d/' % index)

    def tower(self, index: int, x) -> torch.Tensor:
        """Tower ``index`` (1 for input_1, 2 for input_2) of the current
        parameters on an input of any kind, on the model's device:
        [N, F] -> [N, cca_dims]."""
        return self._tower(self._require_params(), index,
                           self.as_tensor(x).float())

    def towers(self) -> 'DccaTowers':
        """Both towers of the current parameters (DccaTowers): their
        weights packed for kernel T1 once, here."""
        return DccaTowers(self, self._require_params())

    def input_widths(self) -> Tuple[int, int]:
        """(F1, F2): the widths the two towers take."""
        params = self._require_params()
        return params['tower1/0/w'].shape[0], params['tower2/0/w'].shape[0]

    def forward(self, input_dict) -> torch.Tensor:
        """[N, F1], [N, F2] -> [N, 2 cca_dims]: (h1 - mean1) @ rot1 |
        (h2 - mean2) @ rot2."""
        params = self._require_params()
        h1 = self.tower(1, input_dict['input_1'])
        h2 = self.tower(2, input_dict['input_2'])
        return torch.cat([(h1 - params['mean1']) @ params['rot1'],
                          (h2 - params['mean2']) @ params['rot2']], dim=1)

    def _loss_fn(self, params, inputs, y_true, gen=None, mesh=None):
        del y_true, gen  # Unsupervised: maximise canonical correlation.
        h1 = self._tower(params, 1, inputs['input_1'])
        h2 = self._tower(params, 2, inputs['input_2'])
        if mesh is not None:
            # The covariances are the whole minibatch's.
            h1, h2 = (mesh_lib.gather_rows(h, mesh) for h in (h1, h2))
        return -cca_solver.cca_loss(h1, h2, self._cca_dims, rcov1=self._reg,
                                    rcov2=self._reg)

    def _set_final_cca(self, solution: cca_solver.CcaSolution):
        self.set_params(dict(self.params, mean1=solution.mean_x,
                             mean2=solution.mean_y, rot1=solution.rot_x,
                             rot2=solution.rot_y))
        self.eigenvalues = solution.eigenvalues.cpu().numpy()

    def fit(self, dataset, epochs: int = 20, batch_size: int = 1024,
            seed: int = 0, **kwargs):
        """The towers' dense SGD fit, then the closed-form CCA of their
        outputs over the same training arrays."""
        history = super().fit(dataset, epochs=epochs, batch_size=batch_size,
                              seed=seed, _keep_arrays=True, **kwargs)
        try:
            with torch.no_grad():
                h1, h2 = (self.tower(i + 1, x)
                          for i, x in enumerate(self._fit_arrays[:2]))
        finally:
            self._fit_arrays = None
        self._set_final_cca(cca_solver.calculate_cca_parameters(
            h1, h2, dim=self._cca_dims, regularization=self._reg))
        return history

    def fit_streaming(self, brain_data, mode: str = 'train',
                      epochs: int = 20, batch_size: int = 1024,
                      seed: int = 0, **kwargs):
        """The towers' streamed SGD fit, then the closed-form CCA from
        the tower outputs' moments, streamed a file at a time (each
        padded to a multiple of 4096 rows and masked)."""
        history = super().fit_streaming(brain_data, mode, epochs=epochs,
                                        batch_size=batch_size, seed=seed,
                                        **kwargs)
        total = None
        for _, (in1, in2, _, _) in brain_data.iter_file_arrays(mode):
            n = min(in1.shape[0], in2.shape[0])
            (x1, x2), valid = pad_to_bucket([in1, in2], n, 4096)
            m = device_policy.as_tensor(valid, self.device)[:, None]
            with torch.no_grad():
                h1, h2 = self.tower(1, x1), self.tower(2, x2)
            stats = moments_from_arrays(h1 * m, h2 * m, want_syy=True)
            stats = stats._replace(count=torch.sum(m))
            total = stats if total is None else total + stats
        self._set_final_cca(cca_solver.solve_cca_from_moments(
            total, dim=self._cca_dims, regularization=self._reg))
        return history
