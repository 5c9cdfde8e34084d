"""Attention decision rules (port of decide/attention_decoder.py):
winner-take-all, the hysteresis stepper and the state-space decoder.

WTA and the stepper are host code on two window scores. The state-space
decoder (Miran et al. 2018) is the fixed-lag Bayesian filter of the JAX
package (telluride_decoding_tpu/decide/attention_decoder.py:224-349):
host ring buffers of the last k_w window correlations, and one window
update a call once they are full, kernel S1 on the card
(ops/ssd_update.py) or its plain version on the CPU. Offline callers
that know the correlations in advance decide whole streams with
``attention_sequence`` and several decoders' streams at once with the
class method ``attention_sequences``: for the state-space decoder, one
launch of S1's sequence form.
"""

from __future__ import annotations

import itertools
from typing import List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from telluride_decoding_torch import device as device_policy
from telluride_decoding_torch.ops.ssd_update import (  # noqa: F401
    SsdConstants, SsdState, WindowLauncher, constants_views, pack,
    ssd_sequence, ssd_update, ssd_update_reference, stack_streams,
    state_views)
from telluride_decoding_torch.utils import profiling


class AttentionDecoder:
    """Winner-take-all: instantaneous comparison, no hysteresis."""

    def attention(self, r1, r2) -> Tuple[Union[float, bool], float, float]:
        return bool(np.mean(r1) > np.mean(r2)), 0, 0

    def tune(self, r1, r2):
        del r1, r2

    @classmethod
    def attention_sequences(cls, decoders, r1s, r2s) -> List[List[Tuple]]:
        """Decides several decoders' streams: for each decoder, the list of
        results of successive ``attention`` calls on the pairs of
        ``r1s[i]`` and ``r2s[i]``, and the decoders left as those calls
        leave them. The state-space decoder does it in one kernel
        launch."""
        return [[dec.attention(a, b) for a, b in zip(r1, r2)]
                for dec, r1, r2 in zip(decoders, r1s, r2s)]

    def attention_sequence(self, r1s, r2s) -> List[Tuple]:
        """Successive ``attention`` calls on the pairs of ``r1s`` and
        ``r2s``, as attention_sequences decides them."""
        return self.attention_sequences([self], [r1s], [r2s])[0]


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
    each window after the warm-up is one launch of S1's window form,
    which reads r1 and r2 from a pinned staging buffer and writes z and
    eta into another, both through their device addresses, and one event
    wait: no copy."""

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
            self._decision_host = torch.empty((2,), pin_memory=True)
            self._done = torch.cuda.Event()
        self._launch = None       # S1's window form on these buffers.
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
        self._launch = None
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
            with profiling.span('s1.wait'):
                return float(z[at]), float(eta[at])
        self._r_host[0].numpy()[:] = self._r1_buf
        self._r_host[1].numpy()[:] = self._r2_buf
        if self._launch is None:
            self._launch = WindowLauncher(
                self._state, self._r_host[0], self._r_host[1],
                self._constants(), self.outer_iter, self.inner_iter,
                self.newton_iter, self.k_w, decision=self._decision_host,
                at=at)
        self._launch()
        with profiling.span('s1.wait'):
            self._done.record()
            profiling.host_wait(self.device)
            self._done.synchronize()
            z, eta = self._decision_host.numpy()
            return float(z), float(eta)

    def attention(self, r1, r2):
        """Processes one new correlation pair; returns (p, lower, upper).

        Returns (0.5, 0.5, 0.5) until the fixed-lag window fills
        (reference :442-452 semantics with k_f = 0)."""
        self.calls += 1
        for buf, r in ((self._r1_buf, r1), (self._r2_buf, r2)):
            buf[:-1] = buf[1:]
            buf[-1] = self._correlation(r)
        if self.calls < self.k_w:
            return (0.5, 0.5, 0.5)
        return self._decide(*self._update())

    def _correlation(self, r) -> float:
        return float(np.abs(np.mean(r) + self._offset))

    def _decide(self, z: float, eta: float):
        """Records a window's z and eta; returns (p, lower, upper)."""
        self.z_dyn.append(z)
        self.eta_dyn.append(eta)
        # Bounds in the documented order lower <= mean <= upper (the
        # reference returns them swapped, attention_decoder.py:448-451).
        half_width = self.c0 * np.sqrt(max(eta, 0.0))
        return (1.0 / (1 + np.exp(-z)),
                1.0 / (1 + np.exp(-(z - half_width))),
                1.0 / (1 + np.exp(-(z + half_width))))

    @classmethod
    def attention_sequences(cls, decoders, r1s, r2s):
        """Successive ``attention`` calls of several state-space decoders
        in one launch of S1's sequence form (its plain version on the
        CPU); returns and leaves what those calls would.

        On top of the base class's contract: the results come from the
        same z and eta through the same float64 expressions, and each
        decoder is left with the calls, ring buffers, packed state, z_dyn
        and eta_dyn those calls would leave. The decoders share one
        device, k_w, k_f and trip counts; each keeps its own constants
        (tune sets mu_0)."""
        decoders = list(decoders)
        if not decoders:
            return []
        first = decoders[0]
        shape = (first.device, first.k_w, first.k_f, first.outer_iter,
                 first.inner_iter, first.newton_iter)
        k_w = first.k_w
        plans = []
        for dec, r1, r2 in zip(decoders, r1s, r2s):
            if (dec.device, dec.k_w, dec.k_f, dec.outer_iter,
                    dec.inner_iter, dec.newton_iter) != shape:
                raise ValueError('attention_sequences: the decoders differ '
                                 'in device, window or trip counts.')
            if len(r1) != len(r2):
                raise ValueError('attention_sequences: %d r1 against %d r2.'
                                 % (len(r1), len(r2)))
            plans.append(_Plan(
                dec, len(r1), min(len(r1), max(0, k_w - 1 - dec.calls)),
                *(np.concatenate([buf, np.asarray(
                    [dec._correlation(r) for r in rs], np.float32)])
                  for buf, rs in ((dec._r1_buf, r1), (dec._r2_buf, r2)))))
        launched = [p for p in plans if p.calls > p.warm]
        decided = {}                    # id(decoder): its (z, eta) rows.
        if launched:
            states, consts = stack_streams(
                [p.decoder._state for p in launched],
                [p.decoder._constants() for p in launched])
            # Call i updates on the ring full[i + 1:i + 1 + k_w], so the
            # calls after the warm-up read the series full[warm + 1:].
            offsets = np.cumsum(
                [0] + [p.calls - p.warm + k_w - 1 for p in launched])
            r1_series = torch.from_numpy(np.concatenate(
                [p.full1[p.warm + 1:] for p in launched])).to(first.device)
            r2_series = torch.from_numpy(np.concatenate(
                [p.full2[p.warm + 1:] for p in launched])).to(first.device)
            states, out = ssd_sequence(
                states, consts, r1_series, r2_series, offsets,
                first.outer_iter, first.inner_iter, first.newton_iter, k_w,
                at=-1 - first.k_f)
            out = out.cpu().numpy()
            for b, p in enumerate(launched):
                for field, new in zip(p.decoder._state,
                                      state_views(states[b], k_w)):
                    field.copy_(new)
                rows = out[offsets[b] - b * (k_w - 1):][:p.calls - p.warm]
                decided[id(p.decoder)] = [(float(z), float(eta))
                                          for z, eta in rows]
        results = []
        for p in plans:
            dec = p.decoder
            results.append([(0.5, 0.5, 0.5)] * p.warm + [
                dec._decide(z, eta) for z, eta in decided.get(id(dec), [])])
            dec._r1_buf = p.full1[p.calls:].copy()
            dec._r2_buf = p.full2[p.calls:].copy()
            dec.calls += p.calls
        return results


class _Plan(NamedTuple):
    """One decoder's part of attention_sequences: its calls, the warm-up
    calls among them, and its ring buffers followed by each call's value
    as attention stores them."""

    decoder: StateSpaceAttentionDecoder
    calls: int
    warm: int
    full1: np.ndarray
    full2: np.ndarray


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
