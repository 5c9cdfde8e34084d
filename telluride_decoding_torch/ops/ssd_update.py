"""One window update of the state-space attention decoder (port of
``_ssd_update``, telluride_decoding_tpu/decide/attention_decoder.py:85-221).

The decoder of Miran et al. (2018) models each window's attended and
unattended correlations as log-normal over a latent attention state z.
One window update is an outer EM loop (E-step responsibilities, MAP
M-step of the log-normal parameters) around an inner loop of a forward
Kalman filter with a Newton solve per step and a backward (RTS) smoother
in true reverse order, as the JAX package runs it. All trip counts are
fixed (20 / 1 / 10 by default).

  * SsdState, SsdConstants: the carried state and the priors, as views
    of one packed float32 buffer each (layouts below).
  * ssd_update_reference: plain torch, float32, fixed-trip Python loops.
    It takes any leading batch dimensions (independent updates), which
    the card checks use to replay many windows in one call.
  * ssd_update: the window form of kernel S1 (csrc/ssd_update.cu),
    which replaces the jitted XLA program ``_ssd_update`` (not a Pallas
    kernel). For CUDA tensors it is one launch that updates the packed
    state buffer in place (JAX's update is functional), reading the
    correlations from, and writing the decision to, pinned host memory
    where the caller stages them there.
  * ssd_sequence: the sequence form of S1, whole series of windows of
    several streams in one launch (offline callers); its plain version
    ssd_sequence_reference loops ssd_update_reference over the windows.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from telluride_decoding_torch import kernels

MAX_WINDOW = 32         # k_w the kernel takes: one lane a window position.
UNMAPPED = -1           # S1's code for a host buffer the card cannot reach.


class SsdState(NamedTuple):
    """Carry state between windows; packed as [mu_d, rho_d, z_kk, sig_kk,
    eta, z_smooth] along the last axis (6 + 4 k_w floats)."""

    mu_d: torch.Tensor       # [2] log-normal means (attended, unattended)
    rho_d: torch.Tensor      # [2] log-normal precisions
    z_kk: torch.Tensor       # [k_w + 1] Kalman filtered state
    sig_kk: torch.Tensor     # [k_w + 1] Kalman filtered variance
    eta: torch.Tensor        # [k_w] state-space variances
    z_smooth: torch.Tensor   # [k_w] the previous window's smoothed z


class SsdConstants(NamedTuple):
    """Priors; packed as [mu_0, alpha_0, beta_0, a_0, b_0, lambda_state]
    (9 floats)."""

    mu_0: torch.Tensor          # [2] prior means
    alpha_0: torch.Tensor       # [2]
    beta_0: torch.Tensor        # [2]
    a_0: torch.Tensor           # scalar inverse-gamma prior
    b_0: torch.Tensor           # scalar
    lambda_state: torch.Tensor  # scalar AR coefficient


def _state_sizes(k_w: int) -> Tuple[int, ...]:
    return (2, 2, k_w + 1, k_w + 1, k_w, k_w)


_CONSTANT_SIZES = (2, 2, 2, 0, 0, 0)      # 0: a scalar.


def _views(buf: torch.Tensor, sizes: Sequence[int]):
    out, at = [], 0
    for size in sizes:
        out.append(buf[..., at] if size == 0 else buf[..., at:at + size])
        at += max(size, 1)
    return out


def state_views(buf: torch.Tensor, k_w: int) -> SsdState:
    """The SsdState whose fields are views of a packed [..., 6 + 4 k_w]
    buffer."""
    return SsdState(*_views(buf, _state_sizes(k_w)))


def constants_views(buf: torch.Tensor) -> SsdConstants:
    """The SsdConstants whose fields are views of a packed [9] buffer."""
    return SsdConstants(*_views(buf, _CONSTANT_SIZES))


def pack(fields) -> torch.Tensor:
    """One contiguous float32 buffer holding ``fields`` in order."""
    return torch.cat([f.reshape(f.shape + (1,)) if f.dim() == 0 else f
                      for f in fields], dim=-1).to(torch.float32)


def packed_buffer(fields, sizes: Sequence[int]) -> torch.Tensor:
    """The contiguous 1-D buffer ``fields`` are consecutive views of, in
    the packed layout; raises if they are not."""
    buf = fields[0]._base
    total = sum(max(s, 1) for s in sizes)
    if (buf is None or buf.dim() != 1 or not buf.is_contiguous() or
            buf.numel() != total or buf.dtype != torch.float32):
        raise ValueError('ssd_update on CUDA takes the state and constants '
                         'as views of one packed float32 buffer '
                         '(state_views, constants_views).')
    at = 0
    for field, size in zip(fields, sizes):
        if (field._base is not buf or field.data_ptr() !=
                buf.data_ptr() + 4 * at or field.numel() != max(size, 1)):
            raise ValueError('ssd_update: fields are not the packed layout.')
        at += max(size, 1)
    return buf


def _log_normal_density(r, mu, rho):
    return (1.0 / r) * torch.sqrt(rho) * torch.exp(
        -0.5 * rho * (torch.log(r) - mu) ** 2)


@torch.no_grad()
def ssd_update_reference(state: SsdState, r1: torch.Tensor,
                         r2: torch.Tensor, consts: SsdConstants,
                         outer_iter: int, inner_iter: int, newton_iter: int,
                         k_w: int):
    """One window update; returns (new_state, z, eta) with z and eta the
    window's [..., k_w] smoothed states and variances. The new state is
    packed (state_views of a new buffer)."""
    kf = float(k_w)
    # Constants may carry the state's batch axes (one set a stream).
    mu_0, alpha_0, beta_0 = consts.mu_0, consts.alpha_0, consts.beta_0
    lam, a_0, b_0 = consts.lambda_state, consts.a_0, consts.b_0
    lam_k, a_0k, b_0k = lam[..., None], a_0[..., None], b_0[..., None]
    mu_d, rho_d = state.mu_d, state.rho_d
    z_kk, sig_kk, eta = state.z_kk, state.sig_kk, state.eta
    z = state.z_smooth
    log_r1 = torch.log(r1)
    log_r2 = torch.log(r2)
    for _ in range(outer_iter):
        # E-step: responsibility that speaker 1 is attended per frame.
        mu_a, mu_u = mu_d[..., 0:1], mu_d[..., 1:2]
        rho_a, rho_u = rho_d[..., 0:1], rho_d[..., 1:2]
        p_11 = _log_normal_density(r1, mu_a, rho_a)
        p_12 = _log_normal_density(r1, mu_u, rho_u)
        p_21 = _log_normal_density(r2, mu_u, rho_u)
        p_22 = _log_normal_density(r2, mu_a, rho_a)
        p = 1.0 / (1.0 + torch.exp(-z))
        ep = (p * p_11 * p_21) / (p * p_11 * p_21 +
                                  (1.0 - p) * p_12 * p_22)

        # M-step: MAP update of the log-normal parameters.
        mu0_new = (torch.sum(ep * log_r1 + (1.0 - ep) * log_r2, -1,
                             keepdim=True) + kf * mu_0[..., 0:1]) / (2.0 * kf)
        mu1_new = (torch.sum(ep * log_r2 + (1.0 - ep) * log_r1, -1,
                             keepdim=True) + kf * mu_0[..., 1:2]) / (2.0 * kf)
        rho0_new = (2.0 * kf * alpha_0[..., 0:1]) / (
            torch.sum(ep * (log_r1 - mu0_new) ** 2 +
                      (1.0 - ep) * (log_r2 - mu0_new) ** 2, -1,
                      keepdim=True) +
            kf * (2.0 * beta_0[..., 0:1] + (mu0_new - mu_0[..., 0:1]) ** 2))
        rho1_new = (2.0 * kf * alpha_0[..., 1:2]) / (
            torch.sum(ep * (log_r2 - mu1_new) ** 2 +
                      (1.0 - ep) * (log_r1 - mu1_new) ** 2, -1,
                      keepdim=True) +
            kf * (2.0 * beta_0[..., 1:2] + (mu1_new - mu_0[..., 1:2]) ** 2))
        mu_d = torch.cat([mu0_new, mu1_new], -1)
        rho_d = torch.cat([rho0_new, rho1_new], -1)

        z_cap = torch.cat([z_kk[..., :1], z], -1)
        for _ in range(inner_iter):
            # Forward Kalman filter over the window, Newton per step.
            z_prev, sig_prev = z_kk[..., 0], sig_kk[..., 0]
            z_f, sig_f, z_pred, sig_pred = [], [], [], []
            for k in range(k_w):
                zp = lam * z_prev
                sp = lam * lam * sig_prev + eta[..., k]
                ep_k = ep[..., k]
                zk = z_kk[..., k + 1]
                for _ in range(newton_iter):
                    e = torch.exp(zk)
                    zk = zk - (zk - zp - sp * (ep_k - e / (1 + e))) / (
                        1 + sp * e / (1 + e) ** 2)
                e = torch.exp(zk)
                sig = 1.0 / (1.0 / sp + e / (1 + e) ** 2)
                z_f.append(zk)
                sig_f.append(sig)
                z_pred.append(zp)
                sig_pred.append(sp)
                z_prev, sig_prev = zk, sig
            z_kk = torch.cat([z_kk[..., :1], torch.stack(z_f, -1)], -1)
            sig_kk = torch.cat([sig_kk[..., :1], torch.stack(sig_f, -1)],
                               -1)
            z_pred = torch.stack(z_pred, -1)
            sig_pred = torch.stack(sig_pred, -1)

            # Backward smoother, in true reverse order.
            sm = sig_kk[..., :-1] * lam_k / sig_pred
            z_next, sig_next = z_kk[..., k_w], sig_kk[..., k_w]
            z_rev, sig_rev = [], []
            for k in range(k_w - 1, -1, -1):
                sm_k = sm[..., k]
                z_next = z_kk[..., k] + sm_k * (z_next - z_pred[..., k])
                sig_next = sig_kk[..., k] + sm_k ** 2 * (
                    sig_next - sig_pred[..., k])
                z_rev.append(z_next)
                sig_rev.append(sig_next)
            z_cap = torch.stack(z_rev[::-1] + [z_kk[..., k_w]], -1)
            sig_cap = torch.stack(sig_rev[::-1] + [sig_kk[..., k_w]], -1)

            z_kk = torch.cat([z_cap[..., :1], z_kk[..., 1:]], -1)
            sig_kk = torch.cat([sig_cap[..., :1], sig_kk[..., 1:]], -1)

            eta = ((z_cap[..., 1:] - z_cap[..., :-1]) ** 2 +
                   sig_cap[..., 1:] + sig_cap[..., :-1] -
                   2.0 * sig_cap[..., 1:] * sm + 2 * b_0k) / (
                       1 + 2 * (a_0k + 1))
        # The next outer E-step uses the smoothed state.
        z = z_cap[..., 1:]

    # Carry the smoothed head into the next window.
    z_kk = torch.cat([z[..., :1], z_kk[..., 1:]], -1)
    new_state = state_views(pack([mu_d, rho_d, z_kk, sig_kk, eta, z]), k_w)
    return new_state, z, eta


def _check_shape(what, k_w, outer_iter, inner_iter, newton_iter, at):
    if not 1 <= k_w <= MAX_WINDOW:
        raise ValueError('%s kernel takes 1 <= k_w <= %d, got %d.'
                         % (what, MAX_WINDOW, k_w))
    if min(outer_iter, inner_iter, newton_iter) < 0:
        raise ValueError('%s: negative trip count.' % what)
    if not -k_w <= at < k_w:
        raise ValueError('%s: index %d outside a window of %d.'
                         % (what, at, k_w))
    return at % k_w


def _check_buffer(what, t, shape, device):
    """A contiguous float32 tensor of ``shape`` that the kernel reads or
    writes in place: on ``device`` or in pinned host memory."""
    if (t.shape != shape or t.dtype != torch.float32 or
            not t.is_contiguous()):
        raise ValueError('ssd_update kernel takes %s as a contiguous '
                         'float32 %s tensor, got %s %s.'
                         % (what, list(shape), tuple(t.shape), t.dtype))
    if t.device != device and not (t.device.type == 'cpu' and
                                   t.is_pinned()):
        raise ValueError('ssd_update kernel takes %s on %s or in pinned '
                         'host memory, got %s.' % (what, device, t.device))


def _ptr(t):
    return None if t is None else t.data_ptr()


def ssd_update(state: SsdState, r1: torch.Tensor, r2: torch.Tensor,
               consts: SsdConstants, outer_iter: int, inner_iter: int,
               newton_iter: int, k_w: int, out=None, *, decision=None,
               at: int = -1):
    """One window update: the window form of kernel S1 on CUDA; returns
    (state, z, eta).

    A state on the CPU takes ssd_update_reference (a new state). A state
    on the card launches the kernel once, which rewrites the packed
    state buffer in place (the state returned is the one given), or
    raises. r1 and r2 are contiguous float32 [k_w] tensors, k_w at most
    32, on the state's card or in pinned host memory, which the kernel
    reads through its device address. z and eta are the rows of ``out``
    ([2, k_w]; a new tensor on the card unless only ``decision`` is
    asked for, then None). ``decision`` ([2], on the card or pinned)
    receives z and eta at window position ``at``: with pinned buffers a
    window is one launch and no copy."""
    if state.mu_d.device.type == 'cpu':
        new_state, z, eta = ssd_update_reference(
            state, r1, r2, consts, outer_iter, inner_iter, newton_iter, k_w)
        if out is not None:
            out.copy_(torch.stack([z, eta]))
        if decision is not None:
            decision.copy_(torch.stack([z[at], eta[at]]))
        return new_state, z, eta
    if out is None and decision is None:
        out = torch.empty((2, k_w), dtype=torch.float32,
                          device=state.mu_d.device)
    WindowLauncher(state, r1, r2, consts, outer_iter, inner_iter,
                   newton_iter, k_w, out=out, decision=decision, at=at)()
    if out is None:
        return state, None, None
    return state, out[0], out[1]


class WindowLauncher:
    """S1's window form bound to fixed buffers (the arguments of
    ssd_update, the state on the card): checked once, then each call is
    one launch on the current stream (counted as ``ssd_update``).
    The serving decoder keeps one, so that a window costs the launch and
    not the checks."""

    def __init__(self, state: SsdState, r1: torch.Tensor, r2: torch.Tensor,
                 consts: SsdConstants, outer_iter: int, inner_iter: int,
                 newton_iter: int, k_w: int, *, out=None, decision=None,
                 at: int = -1):
        device = state.mu_d.device
        if device.type != 'cuda':
            raise ValueError('S1 launches on CUDA tensors, not %s.'
                             % device)
        at = _check_shape('ssd_update', k_w, outer_iter, inner_iter,
                          newton_iter, at)
        for name, r in (('r1', r1), ('r2', r2)):
            _check_buffer(name, r, (k_w,), device)
        state_buf = packed_buffer(state, _state_sizes(k_w))
        const_buf = packed_buffer(consts, _CONSTANT_SIZES)
        if const_buf.device != device:
            raise ValueError('ssd_update: state and constants must share '
                             'one device.')
        if out is not None:
            _check_buffer('out', out, (2, k_w), device)
        if decision is not None:
            _check_buffer('decision', decision, (2,), device)
        self.device = device
        # The tensors stay referenced: the kernel reads their addresses.
        self._buffers = (state_buf, r1, r2, const_buf, out, decision)
        self._args = (state_buf.data_ptr(), r1.data_ptr(), r2.data_ptr(),
                      const_buf.data_ptr(), _ptr(out), _ptr(decision), at,
                      k_w, outer_iter, inner_iter, newton_iter)
        self._launch = kernels.library().tdt_ssd_update

    def __call__(self):
        code = self._launch(*self._args, kernels.stream_handle(self.device))
        if code == UNMAPPED:
            raise ValueError('ssd_update: a pinned host buffer is not '
                             'mapped into the card\'s address space.')
        kernels.check(code, 'ssd_update')


def _segments(offsets, k_w) -> List[int]:
    """The CSR offsets as ints, checked: from 0, each stream's series at
    least k_w - 1 long (its ring buffer before the first window)."""
    offsets = [int(o) for o in torch.as_tensor(offsets).tolist()]
    if len(offsets) < 2 or offsets[0] != 0:
        raise ValueError('ssd_sequence: offsets start at 0 and name at '
                         'least one stream, got %s.' % offsets[:4])
    for lo, hi in zip(offsets, offsets[1:]):
        if hi - lo < k_w - 1:
            raise ValueError('ssd_sequence: a series of %d values is '
                             'shorter than a ring buffer (%d).'
                             % (hi - lo, k_w - 1))
    return offsets


def sequence_windows(offsets: Sequence[int], k_w: int) -> List[int]:
    """Windows of each stream of a CSR series: its length less k_w - 1."""
    return [int(hi - lo) - (k_w - 1) for lo, hi in zip(offsets, offsets[1:])]


def stack_streams(states: Sequence[SsdState],
                  constants: Sequence[SsdConstants]):
    """Several streams' states and constants packed and stacked as
    ssd_sequence takes them: ([S, 6 + 4 k_w], [S, 9]), new tensors."""
    return (torch.stack([pack(list(state)) for state in states]),
            torch.stack([pack(list(consts)) for consts in constants]))


@torch.no_grad()
def ssd_sequence_reference(states: torch.Tensor, consts: torch.Tensor,
                           r1_series: torch.Tensor, r2_series: torch.Tensor,
                           offsets, outer_iter: int, inner_iter: int,
                           newton_iter: int, k_w: int, at: int = -1):
    """Plain version of ssd_sequence: ssd_update_reference window after
    window, each call on the streams that still have a window (batched
    over them). Returns (new states, out) as ssd_sequence does."""
    offsets = _segments(offsets, k_w)
    windows = sequence_windows(offsets, k_w)
    first = [lo - b * (k_w - 1) for b, lo in enumerate(offsets[:-1])]
    states = states.clone()
    out = torch.empty((sum(windows), 2), dtype=torch.float32,
                      device=states.device)
    for j in range(max(windows)):
        active = [b for b, n in enumerate(windows) if n > j]
        rows = torch.tensor(active, device=states.device)
        r1 = torch.stack([r1_series[offsets[b] + j:offsets[b] + j + k_w]
                          for b in active])
        r2 = torch.stack([r2_series[offsets[b] + j:offsets[b] + j + k_w]
                          for b in active])
        new_state, z, eta = ssd_update_reference(
            state_views(states[rows], k_w), r1, r2,
            constants_views(consts[rows]), outer_iter, inner_iter,
            newton_iter, k_w)
        states[rows] = pack(list(new_state))
        out[torch.tensor([first[b] + j for b in active],
                         device=states.device)] = torch.stack(
            [z[:, at], eta[:, at]], 1)
    return states, out


def ssd_sequence(states: torch.Tensor, consts: torch.Tensor,
                 r1_series: torch.Tensor, r2_series: torch.Tensor,
                 offsets, outer_iter: int, inner_iter: int,
                 newton_iter: int, k_w: int, at: int = -1):
    """Series of window updates of several streams: the sequence form of
    kernel S1 on CUDA, one launch for all streams.

    ``states`` [S, 6 + 4 k_w] holds each stream's packed state and
    ``consts`` [S, 9] its packed constants. Stream b's correlations are
    ``r*_series[offsets[b]:offsets[b + 1]]`` (CSR, ``offsets`` a host
    sequence of S + 1 ints from 0): its ring buffer at its first window,
    then one new value a window, so it has offsets[b + 1] - offsets[b] -
    (k_w - 1) windows. Returns (states, out): ``out`` [windows, 2] holds
    z and eta at window position ``at`` of every window, stream after
    stream. CPU tensors take ssd_sequence_reference (new states); CUDA
    tensors launch the kernel once, which rewrites ``states`` in place,
    and give bit for bit what successive ssd_update launches give, or
    raise."""
    if states.device.type == 'cpu':
        return ssd_sequence_reference(states, consts, r1_series, r2_series,
                                      offsets, outer_iter, inner_iter,
                                      newton_iter, k_w, at)
    device = states.device
    if device.type != 'cuda':
        raise ValueError('ssd_sequence takes CPU or CUDA tensors, not %s.'
                         % device)
    at = _check_shape('ssd_sequence', k_w, outer_iter, inner_iter,
                      newton_iter, at)
    offsets = _segments(offsets, k_w)
    streams = len(offsets) - 1
    for name, t, shape in (('states', states, (streams, 6 + 4 * k_w)),
                           ('consts', consts, (streams, 9)),
                           ('r1_series', r1_series, (offsets[-1],)),
                           ('r2_series', r2_series, (offsets[-1],))):
        if (t.shape != shape or t.dtype != torch.float32 or
                not t.is_contiguous() or t.device != device):
            raise ValueError('ssd_sequence kernel takes %s as a contiguous '
                             'float32 %s tensor on %s, got %s %s on %s.'
                             % (name, list(shape), device, tuple(t.shape),
                                t.dtype, t.device))
    out = torch.empty((offsets[-1] - streams * (k_w - 1), 2),
                      dtype=torch.float32, device=device)
    offsets_dev = torch.tensor(offsets, dtype=torch.int64).to(device)
    lib = kernels.library()
    kernels.check(lib.tdt_ssd_sequence(
        states.data_ptr(), consts.data_ptr(), r1_series.data_ptr(),
        r2_series.data_ptr(), offsets_dev.data_ptr(), out.data_ptr(),
        streams, at, k_w, outer_iter, inner_iter, newton_iter,
        kernels.stream_handle(device)), 'ssd_sequence')
    return states, out
