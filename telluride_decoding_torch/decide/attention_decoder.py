"""Attention decision rules (port of decide/attention_decoder.py):
winner-take-all, the hysteresis stepper and the state-space decoder.

WTA and the stepper are host code on two window scores. The state-space
decoder (Miran et al. 2018) is the fixed-lag Bayesian filter of the JAX
package (telluride_decoding_tpu/decide/attention_decoder.py:224-349):
host ring buffers of the last k_w window correlations, and one window
update a call once they are full, kernel S1 on the card
(ops/ssd_update.py) or its plain version on the CPU.
"""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from telluride_decoding_torch import device as device_policy
from telluride_decoding_torch.ops.ssd_update import (  # noqa: F401
    SsdConstants, SsdState, constants_views, pack, ssd_update,
    ssd_update_reference, state_views)


class AttentionDecoder:
    """Winner-take-all: instantaneous comparison, no hysteresis."""

    def attention(self, r1, r2) -> Tuple[Union[float, bool], float, float]:
        return bool(np.mean(r1) > np.mean(r2)), 0, 0

    def tune(self, r1, r2):
        del r1, r2


class StepAttentionDecoder(AttentionDecoder):
    """Hysteresis stepper: state in [0.1, 0.9], +/-0.1 per window."""

    def __init__(self):
        self.state = 0.5

    def attention(self, r1, r2):
        if np.mean(r1) > np.mean(r2):
            self.state = min(0.9, self.state + 0.1)
        else:
            self.state = max(0.1, self.state - 0.1)
        return self.state > 0.5, 0, 0


class StateSpaceAttentionDecoder(AttentionDecoder):
    """Fixed-lag Bayesian attention filter (Miran et al. 2018).

    On a CUDA device the state lives in one packed buffer on the card and
    each window after the warm-up is one copy in (r1 and r2 from a pinned
    staging buffer), one launch of S1 and one copy out (z and eta into
    another pinned buffer)."""

    def __init__(self, outer_iter: int, inner_iter: int, newton_iter: int,
                 fs_corr: float, forward_lag: int = 0,
                 backward_lag: int = 13, offset: float = 0.0, *, device):
        self._offset = offset
        self.outer_iter = outer_iter
        self.inner_iter = inner_iter
        self.newton_iter = newton_iter
        self.fs_corr = fs_corr
        self.k_f = forward_lag
        self.k_b = backward_lag
        self.k_w = self.k_f + self.k_b + 1
        self.c0 = 1.96  # 95% confidence intervals.
        self.device = device_policy.resolve(device)

        # Inverse-gamma prior on the state-space variances.
        self.mean_p = 0.2
        self.var_p = 5
        self.a_0 = 2 + self.mean_p ** 2 / self.var_p
        self.b_0 = self.mean_p * (self.a_0 - 1)

        self.calls = 0
        self.lambda_state = 1.0

        # UMD-tuned prior hyperparameters (reference :264-268).
        self.alpha_0 = [6.4113e+02, 4.0434e+03]
        self.beta_0 = [3.7581e+02, 6.2791e+03]
        self.mu_0 = [-0.3994, -1.5103]
        self.rho_d = [1.7060, 0.64395]
        self.mu_d = [-0.3994, -1.5103]

        # Correlation ring buffers on the host.
        self._r1_buf = np.zeros((self.k_w,), np.float32)
        self._r2_buf = np.zeros((self.k_w,), np.float32)
        k_w = self.k_w
        self._state = state_views(pack([
            torch.tensor(self.mu_d), torch.tensor(self.rho_d),
            torch.zeros(k_w + 1), torch.zeros(k_w + 1),
            torch.full((k_w,), 0.3), torch.zeros(k_w)]).to(self.device), k_w)
        if self.device.type == 'cuda':
            self._r_host = torch.empty((2, k_w), pin_memory=True)
            self._r_dev = torch.empty((2, k_w), device=self.device)
            self._out_dev = torch.empty((2, k_w), device=self.device)
            self._out_host = torch.empty((2, k_w), pin_memory=True)
            self._done = torch.cuda.Event()
        # Seeded with k_w zeros like the reference (:244-248), so z_dyn[i]
        # aligns with call index i.
        self.z_dyn = [0.0] * self.k_w
        self.eta_dyn = [0.0] * self.k_w
        self._constants_cache = None

    def _constants(self) -> SsdConstants:
        # Cached: they only change in __init__ and tune.
        if self._constants_cache is None:
            self._constants_cache = constants_views(pack([
                torch.tensor(self.mu_0), torch.tensor(self.alpha_0),
                torch.tensor(self.beta_0), torch.tensor(self.a_0),
                torch.tensor(self.b_0),
                torch.tensor(self.lambda_state)]).to(self.device))
        return self._constants_cache

    def tune(self, r1: Sequence[float], r2: Sequence[float]):
        return self.tune_log_normal_priors(r1, r2)

    def tune_log_normal_priors(self, r1, r2):
        """MLE of the attended/unattended log-normal parameters
        (reference :277-327; r1 MUST be the attended speaker)."""
        abs_r1 = np.absolute(np.asarray(r1) + self._offset)
        abs_r2 = np.absolute(np.asarray(r2) + self._offset)
        n = abs_r1.shape[0]
        u_a = np.sum(abs_r1) / n
        v_a = np.sum((abs_r1 - u_a) ** 2) / n
        rho_a = 1 / np.log(v_a / u_a ** 2 + 1)
        mu_a = np.log(u_a) - 0.5 / rho_a
        u_u = np.sum(abs_r2) / n
        v_u = np.sum((abs_r2 - u_u) ** 2) / n
        rho_u = 1 / np.log(v_u / u_u ** 2 + 1)
        mu_u = np.log(u_u) - 0.5 / rho_u
        self.rho_d = [rho_a, rho_u]
        self.mu_d = [mu_a, mu_u]
        self.mu_0 = [mu_a, mu_u]
        self._constants_cache = None     # mu_0 is a constant.
        self._state.mu_d.copy_(torch.tensor(self.mu_d, dtype=torch.float32))
        self._state.rho_d.copy_(torch.tensor(self.rho_d,
                                             dtype=torch.float32))

    def _update(self) -> Tuple[float, float]:
        """One window update; (z, eta) at index -1 - k_f."""
        at = -1 - self.k_f
        if self.device.type == 'cpu':
            self._state, z, eta = ssd_update(
                self._state, torch.from_numpy(self._r1_buf.copy()),
                torch.from_numpy(self._r2_buf.copy()), self._constants(),
                self.outer_iter, self.inner_iter, self.newton_iter,
                self.k_w)
            return float(z[at]), float(eta[at])
        self._r_host[0].numpy()[:] = self._r1_buf
        self._r_host[1].numpy()[:] = self._r2_buf
        self._r_dev.copy_(self._r_host, non_blocking=True)
        ssd_update(self._state, self._r_dev[0], self._r_dev[1],
                   self._constants(), self.outer_iter, self.inner_iter,
                   self.newton_iter, self.k_w, out=self._out_dev)
        self._out_host.copy_(self._out_dev, non_blocking=True)
        self._done.record()
        self._done.synchronize()
        out = self._out_host.numpy()
        return float(out[0, at]), float(out[1, at])

    def attention(self, r1, r2):
        """Processes one new correlation pair; returns (p, lower, upper).

        Returns (0.5, 0.5, 0.5) until the fixed-lag window fills
        (reference :442-452 semantics with k_f = 0)."""
        self.calls += 1
        a1 = float(np.abs(np.mean(r1) + self._offset))
        a2 = float(np.abs(np.mean(r2) + self._offset))
        self._r1_buf = np.roll(self._r1_buf, -1)
        self._r1_buf[-1] = a1
        self._r2_buf = np.roll(self._r2_buf, -1)
        self._r2_buf[-1] = a2
        if self.calls < self.k_w:
            return (0.5, 0.5, 0.5)
        z, eta = self._update()
        self.z_dyn.append(z)
        self.eta_dyn.append(eta)
        # Bounds in the documented order lower <= mean <= upper (the
        # reference returns them swapped, attention_decoder.py:448-451).
        half_width = self.c0 * np.sqrt(max(eta, 0.0))
        return (1.0 / (1 + np.exp(-z)),
                1.0 / (1 + np.exp(-(z - half_width))),
                1.0 / (1 + np.exp(-(z + half_width))))


def plot_aad_results(decision: np.ndarray,
                     attention_flag=None, decision_upper=None,
                     decision_lower=None, t=None,
                     xlabel: str = 'Time (frames)',
                     ylabel: str = 'Prob of Speaker 1',
                     title: str = 'AAD Decoding Result',
                     linecolor: str = 'blue'):
    """Plots a decision trace with confidence band + attention shading
    (reference attention_decoder.py:27-113). Does not clear the figure,
    so multiple traces overlay."""
    import matplotlib.pyplot as plt
    from matplotlib import patches

    if not isinstance(decision, np.ndarray):
        raise TypeError('Argument decision must be an np array, not %s' %
                        type(decision))
    for name, arr in [('attention_flag', attention_flag),
                      ('decision_upper', decision_upper),
                      ('decision_lower', decision_lower), ('t', t)]:
        if arr is not None:
            if not isinstance(arr, np.ndarray):
                raise TypeError('Argument %s must be an np array, not %s' %
                                (name, type(arr)))
            if len(decision) != len(arr):
                raise TypeError('Input %s must match length of decision, '
                                'not %d and %d' % (name, len(decision),
                                                   len(arr)))
    if t is None:
        t = np.arange(len(decision))
    plt.plot(t, decision, linecolor)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.title(title)
    if decision_upper is not None and decision_lower is not None:
        plt.fill_between(t, decision_upper, decision_lower,
                         color='light' + linecolor)
    if attention_flag is not None and (np.sum(attention_flag == 0) and
                                       np.sum(attention_flag != 0)):
        axis_limits = plt.axis()
        start_index = 0
        for attention_value, values in itertools.groupby(
                list(attention_flag)):
            duration = len(list(values))
            if attention_value:
                rect = patches.Rectangle(
                    (t[start_index], axis_limits[2]),
                    t[start_index + duration - 1] - t[start_index],
                    axis_limits[3] - axis_limits[2],
                    facecolor='lightgray', alpha=0.5)
                plt.gca().add_patch(rect)
            start_index += duration


def create_attention_decoder(type_name: str, window_step: int = 100,
                             frame_rate: float = 100.0,
                             ssd_offset: float = 0.0, *,
                             device='cuda') -> AttentionDecoder:
    """Factory (reference attention_decoder.py:455-485 semantics). WTA and
    the stepper run on the host and ignore ``device``; the state-space
    decoder's window updates run there."""
    if type_name == 'wta':
        return AttentionDecoder()
    if type_name in ('stepped', 'step'):
        return StepAttentionDecoder()
    if type_name == 'ssd':
        fs_corr = window_step * float(frame_rate) / 2.0
        return StateSpaceAttentionDecoder(20, 1, 10, fs_corr,
                                          offset=ssd_offset, device=device)
    raise ValueError('Unknown type (%s) requested from '
                     'create_attention_decoder' % type_name)
