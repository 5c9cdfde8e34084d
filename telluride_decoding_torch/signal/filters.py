"""IIR (biquad cascade) filtering as a log-depth parallel scan (port of
signal/filters.py).

Each biquad (direct form II transposed, scipy-compatible) is an affine
state recurrence

    z[n+1] = M z[n] + k x[n],   y[n] = b0 x[n] + z1[n]

with constant M = [[-a1, 1], [-a2, 0]] and k = [b1 - a1 b0, b2 - a2 b0].
With w = [zi, k x[0], ..., k x[N-1]], the states are the inclusive scan
z[n] = sum_{j <= n} M^(n-j) w[j], which a doubling (Hillis-Steele) scan
forms in ceil(log2(N+1)) steps of whole-tensor float32 arithmetic on the
caller's device: step d adds M^d applied to the sums d frames back.
There is no per-frame Python loop. The JAX package runs the same
recurrence as lax.associative_scan outside any Pallas kernel
(filters.py:44-124); its frame-bucket padding existed only to reuse XLA
compiles and is gone, the returned (y, zf) are the same. The 2x2
products are written out elementwise, so no TF32 matmul can enter.

Filter design (Butterworth -> SOS) and the steady-state initial
conditions are scipy host code, copied.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.signal
import torch


def butter_sos(order: int, cutoff, btype: str, fs: float) -> np.ndarray:
    """Butterworth design returning second-order sections [S, 6]."""
    return scipy.signal.butter(order, cutoff, btype, output='sos',
                               fs=fs).astype(np.float64)


def sosfilt_zi(sos: np.ndarray) -> np.ndarray:
    """Steady-state initial conditions (scipy.signal.sosfilt_zi)."""
    return scipy.signal.sosfilt_zi(np.asarray(sos, np.float64))


def _biquad_apply(section: np.ndarray, x: torch.Tensor, zi: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DF2T biquad over [N, C]; zi [2, C]. Returns (y [N, C],
    zf [2, C])."""
    b0, b1, b2, _, a1, a2 = (float(v) for v in np.float32(section))
    k0, k1 = float(np.float32(b1 - a1 * b0)), float(np.float32(b2 - a2 * b0))
    # s[n] = z[n] for n in [0, N]: row 0 is zi, row n+1 starts as k x[n].
    s0 = torch.cat([zi[0:1], k0 * x])
    s1 = torch.cat([zi[1:2], k1 * x])
    # P = M^d, updated by squaring; float64 on the host, then rounded.
    p = np.array([[-a1, 1.0], [-a2, 0.0]], np.float32).astype(np.float64)
    d = 1
    while d < s0.shape[0]:
        p00, p01, p10, p11 = (float(v) for v in np.float32(p).reshape(-1))
        prev0, prev1 = s0[:-d], s1[:-d]
        s0 = torch.cat([s0[:d], s0[d:] + p00 * prev0 + p01 * prev1])
        s1 = torch.cat([s1[:d], s1[d:] + p10 * prev0 + p11 * prev1])
        p = np.float32(p).astype(np.float64) @ np.float32(p).astype(
            np.float64)
        d *= 2
    y = b0 * x + s0[:-1]
    return y, torch.stack([s0[-1], s1[-1]])


def sosfilt(sos, x, zi=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filters [N, C] data through an SOS cascade on x's device.

    Matches scipy.signal.sosfilt(sos, x, zi=zi, axis=0): returns
    (filtered [N, C], final state [S, 2, C]) as float32 tensors. ``x``
    and ``zi`` are tensors (or arrays, taken on the CPU); ``zi``
    defaults to zeros. For the EEG passbands used here float32 matches
    scipy to ~1e-4.
    """
    sos = np.asarray(sos, np.float64)
    x = torch.as_tensor(x).float()
    if x.dim() == 1:
        x = x[:, None]
    if zi is None:
        zi = torch.zeros((sos.shape[0], 2, x.shape[1]), dtype=torch.float32,
                         device=x.device)
    else:
        zi = torch.as_tensor(zi).to(x.device, torch.float32)
    y = x
    zfs = []
    # Cascade sections sequentially (S is small).
    for s in range(sos.shape[0]):
        y, zf = _biquad_apply(sos[s], y, zi[s])
        zfs.append(zf)
    return y, torch.stack(zfs)


def streaming_state_init(sos: np.ndarray, first_frame: torch.Tensor
                         ) -> torch.Tensor:
    """Step-response state scaled by the first frame (the reference's
    reset semantics, preprocess.py:293-303): avoids filter onset
    transients when a recording starts at a DC offset. [S, 2, C] float32
    on first_frame's device, formed in float64 as the JAX package does
    on the host."""
    zi = torch.as_tensor(sosfilt_zi(sos), device=first_frame.device)
    return (zi[:, :, None] *
            first_frame.double()[None, None, :]).float()
