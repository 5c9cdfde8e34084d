"""Plain reference of a session served by VLAAI (Accou et al., Sci. Rep.
2023; https://github.com/exporl/vlaai): the network on the EEG's raw
frames, each talker's correlation with its prediction, scaled LDA,
window means (reference/decode.py's) and the winner-take-all rule.

It imports nothing of the program. From the session's raw frames and the
decoder's weights (the harness's seeded inputs) it works out every
frame's two scores:

  conv(h)  = "valid" Conv1D, y[t, o] = b[o] + sum_kc h[t + k, c] W[k, c, o]
  LN       = layer norm over channels, eps 1e-3, scale and shift
  LReLU    = leaky ReLU, slope 0.3
  X(h)     = five times h <- pad_end_{K-1}(LReLU(LN(conv(h))))   (shared)
  O(h)     = LReLU(LN(conv_{K=32}(pad_start_31(h))))             (shared)
  x_0 = 0,  x_i = O(D_i(X(E + x_{i-1})))   (D_i dense 128 -> 64, a block)
  pred_t   = x_4[t] W_out + b_out
  s_tk     = slope * lda_w (y_k[t] - cmx)(pred_t - cmy) / p + intercept

with E the EEG and zeros before its first frame: frame t's prediction is
the network on frames t - pre .. t + post (pre 124, post 140 at the
published widths), which a forward pass over any window holding them
gives at that frame. The scores are computed in blocks of ``block``
frames, each from a window of block + pre + post frames, so the windows
of two blocks overlap by pre + post frames. The harness replays the
session in a loop, so from the second loop on a frame's window holds no
zeros and its score is that of the same frame of the first loop (or, in
its first ``pre`` frames, of the frame one period later): the reference
computes the first period and its next ``pre`` frames, and the scores of
every later frame repeat them.

Each convolution is an unfolded product, so that ``precision`` 'tf32'
(the control) rounds its operands as a card's TF32 product would;
'float64' is the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.decode import _frames
from portbench.reference.precision import as_dtype, matmul

EPS = 1e-3
SLOPE = 0.3


def _conv(h, w, b, precision):
    k, c_in, c_out = w.shape
    n = h.shape[0] - k + 1
    cols = h.unfold(0, k, 1).transpose(1, 2).reshape(n, k * c_in)
    return matmul(cols, w.reshape(k * c_in, c_out), precision) + b


def _ln_act(h, gamma, beta):
    mean = h.mean(1, keepdim=True)
    var = ((h - mean) ** 2).mean(1, keepdim=True)
    h = (h - mean) / torch.sqrt(var + EPS) * gamma + beta
    return torch.where(h > 0, h, SLOPE * h)


def predict(e: torch.Tensor, w: dict, cfg: dict, precision: str
            ) -> torch.Tensor:
    """[n + pre + post, C] frames -> the [n] predictions of frames pre ..
    pre + n - 1."""
    layers = len(cfg['extractor_filters'])
    x = torch.zeros_like(e)
    for i in range(cfg['blocks']):
        h = e + x
        for j in range(layers):
            p = 'extractor/%d/' % j
            h = _ln_act(_conv(h, w[p + 'w'], w[p + 'b'], precision),
                        w[p + 'gamma'], w[p + 'beta'])
            h = torch.nn.functional.pad(h, (0, 0, 0, w[p + 'w'].shape[0] - 1))
        h = matmul(h, w['dense/%d/w' % i], precision) + w['dense/%d/b' % i]
        h = torch.nn.functional.pad(h, (0, 0, cfg['context_kernel'] - 1, 0))
        x = _ln_act(_conv(h, w['context/w'], w['context/b'], precision),
                    w['context/gamma'], w['context/beta'])
    pre, post = cfg['eeg_pre'], cfg['eeg_post']
    x = x[pre:e.shape[0] - post]
    return (matmul(x, w['output/w'], precision) + w['output/b'])[:, 0]


def _scores(session, w, cfg, start, stop, precision, dtype, device, block):
    """Both talkers' scores of frames [start, stop), in blocks."""
    eeg, audio1, audio2 = session
    pre, post = cfg['eeg_pre'], cfg['eeg_post']

    def tensor(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)
    scale = (w['lda_slope'] * w['lda_w'][0, 0] / w['corr_power'][0])
    out_a, out_b = [], []
    for t0 in range(start, stop, block):
        t1 = min(stop, t0 + block)
        prediction = predict(tensor(_frames(eeg, t0 - pre, t1 + post)), w,
                             cfg, precision) - w['corr_mean_y'][0]
        for stream, out in ((audio1, out_a), (audio2, out_b)):
            y = tensor(_frames(stream, t0, t1))[:, 0] - w['corr_mean_x'][0]
            s = y * prediction * scale + w['lda_intercept']
            out.append(s.double().cpu().numpy())
    return np.concatenate(out_a), np.concatenate(out_b)


def frame_scores(session, weights: dict, cfg: dict, frames: int, device,
                 precision: str = 'float64', block: int = 16384):
    """(s_a, s_b): [frames] float64 host arrays, the scores of the first
    ``frames`` emitted frames against talker 1 and talker 2."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = as_dtype(precision)
    w = {k: (torch.as_tensor(np.asarray(v), device=device).to(dtype)
             if isinstance(v, np.ndarray) else v)
         for k, v in weights.items()}
    period = session[0].shape[0]
    first = min(frames, period + cfg['eeg_pre'])
    out = _scores(session, w, cfg, 0, first, precision, dtype, device, block)
    if frames <= first:
        return out
    # Frame t >= period scores as frame t % period of one loop in, whose
    # first pre frames are the ones after the first period.
    idx = np.arange(period, frames) % period
    idx = np.where(idx < cfg['eeg_pre'], idx + period, idx)
    return tuple(np.concatenate([s[:period], s[idx]]) for s in out)
