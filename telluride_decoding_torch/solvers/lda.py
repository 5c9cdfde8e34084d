"""Linear discriminant analysis with 0/1 output scaling (port of
solvers/lda.py).

The generalized symmetric eigenproblem Sb w = lambda Sw w is solved by
Cholesky whitening plus eigh, all real. The parameter schema keeps the
reference's re/im split (w_imag = 0), so decoder_model.json files are
interchangeable with the JAX package.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Union

import numpy as np
import torch


class LdaParams(NamedTuple):
    """Serializable LDA parameters (the reference LdaParamsTuple schema)."""

    w_real: Any
    w_imag: Any
    labels: Any
    mean_vectors: Any
    slope: Any
    intercept: Any


def _scatter_matrices(x: torch.Tensor, onehot: torch.Tensor):
    """Within/between class scatter from data and a [N, K] class onehot."""
    counts = onehot.sum(0)                                # [K]
    sums = onehot.T @ x                                   # [K, D]
    means = sums / counts[:, None]
    sw = x.T @ x - means.T @ (means * counts[:, None])
    overall = sums.sum(0) / counts.sum()
    diff = means - overall[None, :]
    sb = diff.T @ (diff * counts[:, None])
    return sw, sb, means


def _lda_fit(x: torch.Tensor, onehot: torch.Tensor):
    """Projection (unit columns, by descending |eigenvalue|), eigenvalues
    and class means (telluride_decoding_tpu/solvers/lda.py:74-93)."""
    sw, sb, means = _scatter_matrices(x, onehot)
    d = x.shape[1]
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    # Jitter keeps the Cholesky factorizable for near-singular scatter.
    jitter = 1e-6 * (torch.trace(sw) / d + 1e-30)
    chol, info = torch.linalg.cholesky_ex(sw + jitter * eye)
    if int(info) or not bool(torch.isfinite(chol).all() and
                             torch.isfinite(sb).all()):
        # JAX's cholesky gives NaN where it fails and the NaN runs through
        # the solves and eigh into the projection (a driver then reports
        # d' nan, as for a regressor whose output is constant); torch's
        # eigh would raise on it.
        nan = torch.full((d, d), float('nan'), dtype=x.dtype,
                         device=x.device)
        return nan, nan[0], means
    # L M L^T = Sb -> M = L^-1 Sb L^-T.
    li_sb = torch.linalg.solve_triangular(chol, sb, upper=False)
    m = torch.linalg.solve_triangular(chol, li_sb.T, upper=False).T
    vals, vecs = torch.linalg.eigh(0.5 * (m + m.T))
    order = torch.argsort(-vals.abs(), stable=True)
    vals = vals[order]
    # Back-transform w = L^-T u, then unit columns.
    w = torch.linalg.solve_triangular(chol.T, vecs[:, order], upper=True)
    w = w / torch.linalg.norm(w, dim=0, keepdim=True)
    return w, vals, means


class LinearDiscriminantAnalysis:
    """LDA with the reference's API: fit/transform/fit_transform.

    ``device`` is where the fit runs; inputs and outputs are numpy.
    """

    def __init__(self, device):
        self._device = torch.device(device)
        self._labels: List[Any] = []
        self._mean_vectors = []
        self._w: Optional[np.ndarray] = None
        self._eigen_vals: Optional[np.ndarray] = None

    @property
    def mean_vectors(self):
        return self._mean_vectors

    @property
    def coef_array(self):
        return self._w

    @property
    def labels(self):
        return self._labels

    @property
    def model_parameters(self) -> LdaParams:
        w = self._w
        return LdaParams(
            w_real=np.real(w) if w is not None else None,
            w_imag=np.imag(w) if w is not None else None,
            labels=self._labels, mean_vectors=self._mean_vectors,
            slope=None, intercept=None)

    @model_parameters.setter
    def model_parameters(self, values: LdaParams):
        self._set_parameters(values)

    def _set_parameters(self, values: LdaParams):
        values = LdaParams(*values)
        if values.w_real is not None:
            self._w = np.array(values.w_real) + 1j * np.array(values.w_imag)
            if np.all(np.imag(self._w) == 0):
                self._w = np.real(self._w)
        else:
            self._w = None
        self._labels = np.array(values.labels)
        self._mean_vectors = np.array(values.mean_vectors)

    @classmethod
    def from_fitted_data(cls, x, y, *, device) -> 'LinearDiscriminantAnalysis':
        """A new LDA of this class, fitted to (x, y) on ``device``
        (telluride_decoding_tpu/solvers/lda.py:142-146)."""
        obj = cls(device)
        obj.fit(x, y)
        return obj

    @staticmethod
    def expand_dims(data) -> np.ndarray:
        data = np.asarray(data)
        if data.ndim == 1:
            data = np.reshape(data, (-1, 1))
        return data

    def fit(self, x, y):
        x = self.expand_dims(x)
        y = np.asarray(y)
        self._labels = sorted(set(y.tolist()))
        onehot = np.stack([(y == label).astype(np.float32)
                           for label in self._labels], axis=1)
        w, vals, means = _lda_fit(
            torch.as_tensor(np.asarray(x, np.float32), device=self._device),
            torch.as_tensor(onehot, device=self._device))
        means = means.cpu().numpy()
        self._mean_vectors = [means[i] for i in range(len(self._labels))]
        if x.shape[1] > 1:
            self._w = w.cpu().numpy()[:, :2]
            self._eigen_vals = np.abs(vals.cpu().numpy())
        else:
            self._w = np.array([[1.0]])
            self._eigen_vals = np.ones((1,))

    def transform(self, x) -> np.ndarray:
        if self._w is None:
            raise ValueError('Must fit the model before transforming.')
        x = self.expand_dims(x)
        if np.ndim(x) != 2 or self._w.shape[0] != x.shape[1]:
            raise TypeError(
                'Inconsistent training and transform sizes. %s vs %s'
                % (x.shape, self._w.shape))
        return np.real(x.dot(self._w))

    def fit_transform(self, x, y) -> np.ndarray:
        self.fit(x, y)
        return self.transform(x)

    def explained_variance_ratio(self) -> np.ndarray:
        if self._w is None:
            raise ValueError('Must fit the model before transforming.')
        if self._eigen_vals is None:
            raise ValueError('Eigenvalues unavailable: this LDA was '
                             'restored from serialized parameters; '
                             'explained_variance_ratio needs a fit().')
        return self._eigen_vals / np.sum(self._eigen_vals)


class ScaledLinearDiscriminantAnalysis(LinearDiscriminantAnalysis):
    """LDA refined so the two class means map exactly to 0 and 1."""

    def __init__(self, device):
        super().__init__(device)
        self._slope = 1.0
        self._intercept = 0.0

    @property
    def slope(self) -> float:
        return self._slope

    @property
    def intercept(self) -> float:
        return self._intercept

    @property
    def model_parameters(self) -> LdaParams:
        base = super().model_parameters
        return base._replace(slope=self._slope, intercept=self._intercept)

    @model_parameters.setter
    def model_parameters(self, values: LdaParams):
        self._set_parameters(values)

    def _set_parameters(self, values: LdaParams):
        values = LdaParams(*values)
        super()._set_parameters(values)
        self._slope = values.slope
        self._intercept = values.intercept

    def fit(self, x, y, y0: Union[float, np.ndarray] = 0,
            y1: Union[float, np.ndarray] = 1):
        x = self.expand_dims(x)
        super().fit(x, y)
        if len(self._labels) != 2:
            raise ValueError('Scaled LDA can only be done on two-class data.')
        x0 = super().transform(
            np.reshape(self._mean_vectors[0], (1, -1)))[0, 0]
        x1 = super().transform(
            np.reshape(self._mean_vectors[1], (1, -1)))[0, 0]
        if x0 == x1:
            raise ValueError('X0 and X1 in Scaled LDA are identical '
                             '(%g and %g)' % (x0, x1))
        self._slope = float((y0 - y1) / (x0 - x1))
        self._intercept = float(y0 - self._slope * x0)

    def fit_two_classes(self, class0, class1):
        """Fits from two arrays, class0 mapping to 0 and class1 to 1."""
        class0 = np.asarray(class0)
        class1 = np.asarray(class1)
        if class0.ndim != class1.ndim or (
                class0.ndim > 1 and class0.shape[1] != class1.shape[1]):
            raise ValueError(
                'Class 0 and Class1 must have the same number of '
                'dimensions (%s vs %s).' % (class0.shape, class1.shape))
        x = np.concatenate((class0, class1), axis=0)
        y = np.concatenate((np.zeros(class0.shape[0]),
                            np.ones(class1.shape[0])))
        self.fit(x, y)

    def transform(self, x) -> np.ndarray:
        x_lda = super().transform(x)
        return np.real(self._slope * x_lda + self._intercept)
