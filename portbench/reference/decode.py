"""Plain reference of a served session: lag stack, CCA rotations,
correlation, scaled LDA, window means and the winner-take-all rule.

It imports nothing of the program. From the session's raw frames and
the decoder's weights (the harness's seeded inputs) it works out every
frame's two scores and every window's means:

  x1_t  = [eeg[t - pre], ..., eeg[t + post]]      (zeros before frame 0)
  r1_t  = (x1_t - mean1) @ rot1,  r2_t = (x2_t - mean2) @ rot2
  s_t   = slope * sum_d lda_w[d] (r1_td - cmx_d)(r2_td - cmy_d) / p_d
          + intercept
  c_i   = mean of s over frames [i * step, i * step + width)

``precision`` 'float64' is the reference; 'tf32' is the control: the
same sums in float32 with every product's operands rounded to TF32's
10-bit mantissa, as a card computes a float32 product with TF32 on.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.precision import as_dtype, matmul


def _frames(stream: np.ndarray, start: int, stop: int) -> np.ndarray:
    """Frames [start, stop) of a stream replayed end to end (the harness
    loops the session), zeros before frame 0."""
    length = stream.shape[0]
    idx = np.arange(start, stop)
    out = stream[np.clip(idx, 0, None) % length]
    out[idx < 0] = 0.0
    return out


def frame_scores(session, weights: dict, cfg: dict, frames: int, device,
                 precision: str = 'float64', block: int = 16384):
    """(s_a, s_b): [frames] float64 host arrays, the scores of the first
    ``frames`` emitted frames against talker 1 and talker 2."""
    eeg, audio1, audio2 = session
    dtype = as_dtype(precision)

    def tensor(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)
    rot1, rot2 = tensor(weights['rot1']), tensor(weights['rot2'])
    mean1, mean2 = tensor(weights['mean1']), tensor(weights['mean2'])
    cmx, cmy = tensor(weights['corr_mean_x']), tensor(weights['corr_mean_y'])
    scale = (weights['lda_slope'] * tensor(weights['lda_w'][:, 0]) /
             tensor(weights['corr_power']))
    out_a, out_b = [], []
    for t0 in range(0, frames, block):
        t1 = min(frames, t0 + block)

        def stacked(stream, pre, post):
            raw = tensor(_frames(stream, t0 - pre, t1 + post))
            # [t1 - t0, C, lags] -> lag-major rows, as the stacked columns.
            return raw.unfold(0, pre + 1 + post, 1).transpose(1, 2).reshape(
                t1 - t0, -1)
        x1 = stacked(eeg, cfg['eeg_pre'], cfg['eeg_post'])
        r1 = matmul(x1 - mean1, rot1, precision) - cmx
        for stream, out in ((audio1, out_a), (audio2, out_b)):
            x2 = stacked(stream, cfg['audio_pre'], cfg['audio_post'])
            r2 = matmul(x2 - mean2, rot2, precision) - cmy
            s = (r1 * r2 * scale).sum(1) + weights['lda_intercept']
            out.append(s.double().cpu().numpy())
    return np.concatenate(out_a), np.concatenate(out_b)


def window_means(scores: np.ndarray, windows: int, width: int,
                 step: int) -> np.ndarray:
    """[windows] means of frames [i * step, i * step + width)."""
    csum = np.concatenate([[0.0], np.cumsum(scores, dtype=np.float64)])
    starts = np.arange(windows) * step
    return (csum[starts + width] - csum[starts]) / width


def windows_for(frames: int, width: int, step: int) -> int:
    """Windows complete once ``frames`` scores have arrived."""
    return 0 if frames < width else (frames - width) // step + 1


def wta(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Winner-take-all: talker 1 where its window mean is larger."""
    return c1 > c2
