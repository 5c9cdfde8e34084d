"""Plain reference of the state-space attention decoder (Miran et al.
2018) as served: one window update a window, in float64 NumPy.

A frozen copy of the port's plain update (``ssd_update_reference``, the
fixed-trip loops of the JAX package's ``_ssd_update``), written in NumPy
so that it imports nothing of the program. Leading batch axes are
independent updates. The priors are the published ones the decoder
starts from (the JAX package's attention_decoder.py:237-268).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

OUTER, INNER, NEWTON = 20, 1, 10       # create_attention_decoder('ssd').
BACKWARD_LAG, FORWARD_LAG = 13, 0
K_W = BACKWARD_LAG + FORWARD_LAG + 1
MU_D = (-0.3994, -1.5103)
RHO_D = (1.7060, 0.64395)
ALPHA_0 = (6.4113e+02, 4.0434e+03)
BETA_0 = (3.7581e+02, 6.2791e+03)
MEAN_P, VAR_P = 0.2, 5.0
A_0 = 2 + MEAN_P ** 2 / VAR_P
B_0 = MEAN_P * (A_0 - 1)
LAMBDA_STATE = 1.0
C0 = 1.96


class State(NamedTuple):
    mu_d: np.ndarray       # [..., 2]
    rho_d: np.ndarray      # [..., 2]
    z_kk: np.ndarray       # [..., k_w + 1]
    sig_kk: np.ndarray     # [..., k_w + 1]
    eta: np.ndarray        # [..., k_w]
    z_smooth: np.ndarray   # [..., k_w]


SIZES = (2, 2, K_W + 1, K_W + 1, K_W, K_W)


def initial_state() -> State:
    return State(np.array(MU_D), np.array(RHO_D), np.zeros(K_W + 1),
                 np.zeros(K_W + 1), np.full(K_W, 0.3), np.zeros(K_W))


def unpack(packed: np.ndarray) -> State:
    """A State from [..., 6 + 4 k_w] values in the order of its fields."""
    packed = np.asarray(packed, np.float64)
    out, at = [], 0
    for size in SIZES:
        out.append(packed[..., at:at + size])
        at += size
    return State(*out)


def _density(r, mu, rho):
    return (1.0 / r) * np.sqrt(rho) * np.exp(-0.5 * rho * (np.log(r) - mu)
                                             ** 2)


def update(state: State, r1: np.ndarray, r2: np.ndarray):
    """One window update on the rings r1, r2 [..., k_w]; returns
    (new_state, z, eta), z and eta the window's [..., k_w] smoothed
    states and variances."""
    kf = float(K_W)
    mu_0 = np.broadcast_to(np.array(MU_D), np.shape(state.mu_d))
    alpha_0, beta_0 = np.array(ALPHA_0), np.array(BETA_0)
    lam = LAMBDA_STATE
    mu_d, rho_d = state.mu_d, state.rho_d
    z_kk, sig_kk, eta = state.z_kk, state.sig_kk, state.eta
    z = state.z_smooth
    log_r1, log_r2 = np.log(r1), np.log(r2)
    for _ in range(OUTER):
        mu_a, mu_u = mu_d[..., 0:1], mu_d[..., 1:2]
        rho_a, rho_u = rho_d[..., 0:1], rho_d[..., 1:2]
        p_11 = _density(r1, mu_a, rho_a)
        p_12 = _density(r1, mu_u, rho_u)
        p_21 = _density(r2, mu_u, rho_u)
        p_22 = _density(r2, mu_a, rho_a)
        p = 1.0 / (1.0 + np.exp(-z))
        ep = (p * p_11 * p_21) / (p * p_11 * p_21 + (1.0 - p) * p_12 * p_22)

        mu0 = (np.sum(ep * log_r1 + (1.0 - ep) * log_r2, -1, keepdims=True)
               + kf * mu_0[..., 0:1]) / (2.0 * kf)
        mu1 = (np.sum(ep * log_r2 + (1.0 - ep) * log_r1, -1, keepdims=True)
               + kf * mu_0[..., 1:2]) / (2.0 * kf)
        rho0 = (2.0 * kf * alpha_0[0]) / (
            np.sum(ep * (log_r1 - mu0) ** 2 + (1.0 - ep) * (log_r2 - mu0)
                   ** 2, -1, keepdims=True) +
            kf * (2.0 * beta_0[0] + (mu0 - mu_0[..., 0:1]) ** 2))
        rho1 = (2.0 * kf * alpha_0[1]) / (
            np.sum(ep * (log_r2 - mu1) ** 2 + (1.0 - ep) * (log_r1 - mu1)
                   ** 2, -1, keepdims=True) +
            kf * (2.0 * beta_0[1] + (mu1 - mu_0[..., 1:2]) ** 2))
        mu_d = np.concatenate([mu0, mu1], -1)
        rho_d = np.concatenate([rho0, rho1], -1)

        z_cap = np.concatenate([z_kk[..., :1], z], -1)
        for _ in range(INNER):
            # Forward Kalman filter over the window, Newton per step.
            z_prev, sig_prev = z_kk[..., 0], sig_kk[..., 0]
            z_f, sig_f, z_pred, sig_pred = [], [], [], []
            for k in range(K_W):
                zp = lam * z_prev
                sp = lam * lam * sig_prev + eta[..., k]
                ep_k = ep[..., k]
                zk = z_kk[..., k + 1]
                for _ in range(NEWTON):
                    e = np.exp(zk)
                    zk = zk - (zk - zp - sp * (ep_k - e / (1 + e))) / (
                        1 + sp * e / (1 + e) ** 2)
                e = np.exp(zk)
                sig = 1.0 / (1.0 / sp + e / (1 + e) ** 2)
                z_f.append(zk)
                sig_f.append(sig)
                z_pred.append(zp)
                sig_pred.append(sp)
                z_prev, sig_prev = zk, sig
            z_kk = np.concatenate([z_kk[..., :1], np.stack(z_f, -1)], -1)
            sig_kk = np.concatenate([sig_kk[..., :1], np.stack(sig_f, -1)],
                                    -1)
            z_pred = np.stack(z_pred, -1)
            sig_pred = np.stack(sig_pred, -1)

            # Backward smoother, in true reverse order.
            sm = sig_kk[..., :-1] * lam / sig_pred
            z_next, sig_next = z_kk[..., K_W], sig_kk[..., K_W]
            z_rev, sig_rev = [], []
            for k in range(K_W - 1, -1, -1):
                sm_k = sm[..., k]
                z_next = z_kk[..., k] + sm_k * (z_next - z_pred[..., k])
                sig_next = sig_kk[..., k] + sm_k ** 2 * (
                    sig_next - sig_pred[..., k])
                z_rev.append(z_next)
                sig_rev.append(sig_next)
            z_cap = np.stack(z_rev[::-1] + [z_kk[..., K_W]], -1)
            sig_cap = np.stack(sig_rev[::-1] + [sig_kk[..., K_W]], -1)

            z_kk = np.concatenate([z_cap[..., :1], z_kk[..., 1:]], -1)
            sig_kk = np.concatenate([sig_cap[..., :1], sig_kk[..., 1:]], -1)

            eta = ((z_cap[..., 1:] - z_cap[..., :-1]) ** 2 +
                   sig_cap[..., 1:] + sig_cap[..., :-1] -
                   2.0 * sig_cap[..., 1:] * sm + 2 * B_0) / (
                       1 + 2 * (A_0 + 1))
        z = z_cap[..., 1:]

    z_kk = np.concatenate([z[..., :1], z_kk[..., 1:]], -1)
    return State(mu_d, rho_d, z_kk, sig_kk, eta, z), z, eta


def decision(z: float, eta: float):
    """(p, lower, upper) of a window's z and eta at the fixed lag."""
    half = C0 * np.sqrt(max(eta, 0.0))
    return (1.0 / (1 + np.exp(-z)), 1.0 / (1 + np.exp(-(z - half))),
            1.0 / (1 + np.exp(-(z + half))))


def ring(correlations: np.ndarray, window: int) -> np.ndarray:
    """The k_w correlations the decoder holds when it decides window
    ``window`` (0-based): |window mean| of windows window-k_w+1..window."""
    return np.abs(correlations[window - K_W + 1:window + 1])


def sequence(c1: np.ndarray, c2: np.ndarray, windows: int):
    """[windows, 3] (p, lower, upper) of the decoder's first ``windows``
    windows, followed from its initial state; (0.5, 0.5, 0.5) until its
    ring fills."""
    state = initial_state()
    out = []
    for w in range(windows):
        if w < K_W - 1:
            out.append((0.5, 0.5, 0.5))
            continue
        state, z, eta = update(state, ring(c1, w), ring(c2, w))
        out.append(decision(z[..., -1 - FORWARD_LAG],
                            eta[..., -1 - FORWARD_LAG]))
    return np.asarray(out)


def from_states(states: np.ndarray, windows, c1: np.ndarray,
                c2: np.ndarray) -> np.ndarray:
    """[S, 3] (p, lower, upper) of windows ``windows`` [S], each updated
    from the program's state before it ([S, 6 + 4 k_w], the packed
    layout) on the reference's own rings: all in one batched update."""
    windows = np.asarray(windows)
    r1 = np.stack([ring(c1, w) for w in windows])
    r2 = np.stack([ring(c2, w) for w in windows])
    _, z, eta = update(unpack(states), r1, r2)
    at = -1 - FORWARD_LAG
    return np.asarray([decision(zz, ee) for zz, ee in zip(z[:, at],
                                                           eta[:, at])])
