"""Plain reference of a session served by a deep CCA (DCCA) decoder:
lag stacks, the two ReLU towers, the final CCA, correlation, scaled LDA,
window means (reference/decode.py's) and the winner-take-all rule.

It imports nothing of the program. From the session's raw frames and
the decoder's weights (the harness's seeded inputs) it works out every
frame's two scores:

  x1_t  = [eeg[t - pre], ..., eeg[t + post]]      (zeros before frame 0)
  h     = tower(x): ReLU(x W0 + b0), ReLU(. W1 + b1), . W2 + b2
  r1_t  = (h1_t - mean1) @ rot1,  r2_t = (h2_t - mean2) @ rot2
  s_t   = slope * sum_d lda_w[d] (r1_td - cmx_d)(r2_td - cmy_d) / p_d
          + intercept

The deep CCA is Andrew et al., ICML 2013, with the package's departures
(tests/plain_dcca.py lists them): ReLU hidden layers, lag-stacked
inputs, one audio tower for both talkers, LDA scoring of windows.

``precision`` 'float64' is the reference; 'tf32' is the control: the
same sums in float32 with every product's operands rounded to TF32's
10-bit mantissa, the towers' products included.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.decode import _frames
from portbench.reference.precision import as_dtype, matmul


def tower(x: torch.Tensor, layers, precision: str) -> torch.Tensor:
    """``layers`` [(w, b), ...]: ReLU after each but the last."""
    for i, (w, b) in enumerate(layers):
        x = matmul(x, w, precision) + b
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def frame_scores(session, weights: dict, cfg: dict, frames: int, device,
                 precision: str = 'float64', block: int = 16384):
    """(s_a, s_b): [frames] float64 host arrays, the scores of the first
    ``frames`` emitted frames against talker 1 and talker 2."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eeg, audio1, audio2 = session
    dtype = as_dtype(precision)

    def tensor(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)
    depth = len(cfg['hidden_units']) + 1
    towers = [[(tensor(weights['tower%d/%d/w' % (index, i)]),
                tensor(weights['tower%d/%d/b' % (index, i)]))
               for i in range(depth)] for index in (1, 2)]
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
        h1 = tower(stacked(eeg, cfg['eeg_pre'], cfg['eeg_post']), towers[0],
                   precision)
        r1 = matmul(h1 - mean1, rot1, precision) - cmx
        for stream, out in ((audio1, out_a), (audio2, out_b)):
            h2 = tower(stacked(stream, cfg['audio_pre'], cfg['audio_post']),
                       towers[1], precision)
            r2 = matmul(h2 - mean2, rot2, precision) - cmy
            s = (r1 * r2 * scale).sum(1) + weights['lda_intercept']
            out.append(s.double().cpu().numpy())
    return np.concatenate(out_a), np.concatenate(out_b)
