"""Plain reference of a session served by a regression decoder, the
toolbox's fullyconnected DNN regressor: the EEG's lag stack, the
regressor, each talker's correlation with its prediction, scaled LDA,
window means (reference/decode.py's) and the winner-take-all rule.

It imports nothing of the program. From the session's raw frames and
the decoder's weights (the harness's seeded inputs) it works out every
frame's two scores:

  x_t    = [eeg[t - pre], ..., eeg[t + post]]      (zeros before frame 0)
  pred_t = ReLU(x_t W0 + b0) -> ReLU(. W1 + b1) -> . W2 + b2
  s_tk   = slope * sum_d lda_w[d] (y_k[t]_d - cmx_d)(pred_td - cmy_d) / p_d
           + intercept                    (y_k: talker k's envelope)

One prediction serves both talkers: the regressor reads the EEG alone.
Batch norm and dropout are off in the configuration, as the toolbox's
flags default them (tests/plain_dnn.py folds batch norm where a model
has it).

``precision`` 'float64' is the reference; 'tf32' is the control: the
same sums in float32 with every product's operands rounded to TF32's
10-bit mantissa, the regressor's products included.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.decode import _frames
from portbench.reference.dcca import tower
from portbench.reference.precision import as_dtype


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
    layers = [(tensor(weights['layers/%d/w' % i]),
               tensor(weights['layers/%d/b' % i]))
              for i in range(len(cfg['hidden_units']) + 1)]
    cmx, cmy = tensor(weights['corr_mean_x']), tensor(weights['corr_mean_y'])
    scale = (weights['lda_slope'] * tensor(weights['lda_w'][:, 0]) /
             tensor(weights['corr_power']))
    pre, post = cfg['eeg_pre'], cfg['eeg_post']
    out_a, out_b = [], []
    for t0 in range(0, frames, block):
        t1 = min(frames, t0 + block)
        raw = tensor(_frames(eeg, t0 - pre, t1 + post))
        # [t1 - t0, C, lags] -> lag-major rows, as the stacked columns.
        x = raw.unfold(0, pre + 1 + post, 1).transpose(1, 2).reshape(
            t1 - t0, -1)
        prediction = tower(x, layers, precision) - cmy
        for stream, out in ((audio1, out_a), (audio2, out_b)):
            y = tensor(_frames(stream, t0, t1)) - cmx
            s = (y * prediction * scale).sum(1) + weights['lda_intercept']
            out.append(s.double().cpu().numpy())
    return np.concatenate(out_a), np.concatenate(out_b)
