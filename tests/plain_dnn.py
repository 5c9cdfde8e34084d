"""Plain reference of a served regression attention decoder: the
toolbox's fullyconnected DNN regressor (``--dnn_regressor
fullyconnected``), or a linear regressor as a DNN of no hidden layer.

Straight-line torch in float32 (or float64) with TF32 off, importing
nothing of the port and no JAX, from a session's raw frames and the
decoder's weights to every window's two means and its winner-take-all
decision:

  x_t    = [eeg[t - pre], ..., eeg[t + post]]          (zeros before 0)
  pred_t = relu(x_t W0 + b0) -> relu(. W1 + b1) -> . W2 + b2
  c_tk   = (y_k[t] - cmx) (pred_t - cmy) / p           (talker k's
           envelope y_k, one correlation a frame and output)
  s_tk   = slope * (c_tk @ lda_w) + intercept          (the scaled LDA,
           D = 1 for one output)
  c_ik   = mean of s_k over frames [i * step, i * step + width)
  talker 1 attended where c_i1 > c_i2

One prediction serves both talkers: the regressor reads the EEG alone.
Departures from ``BrainModelDNN._forward`` (the model at inference):

  * Batch norm, where the model has it, is folded to its inference
    affine: x * (gamma / sqrt(var + 1e-5)) + (beta - mean * gamma /
    sqrt(var + 1e-5)), where the model normalises and then scales.
  * Dropout is absent: the model drops units only in training.

``weights`` holds the model's parameters under their weights.npz names
(``layers/0/w`` [in, out], ``layers/0/b`` [out], ...; with batch norm
``bn/i/gamma``, ``bn/i/beta``, ``bn/i/mean``, ``bn/i/var`` of hidden
layer i) and the decoder's statistics and LDA (``corr_mean_x``,
``corr_mean_y``, ``corr_power`` [out], ``lda_w`` [out, 1],
``lda_slope``, ``lda_intercept``).
"""

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EPS = 1e-5


def lag_stack(x: torch.Tensor, pre: int, post: int) -> torch.Tensor:
    """[n, C] -> [n, (pre + 1 + post) C]: row t holds frames t - pre to
    t + post, lag by lag, zeros outside the stream."""
    n, channels = x.shape
    rows = torch.zeros((n, pre + 1 + post, channels), dtype=x.dtype)
    for i, lag in enumerate(range(-pre, post + 1)):
        lo, hi = max(0, -lag), min(n, n - lag)
        rows[lo:hi, i] = x[lo + lag:hi + lag]
    return rows.reshape(n, -1)


def predict(x: torch.Tensor, weights: dict) -> torch.Tensor:
    """The regressor: ReLU hidden layers (each after its folded batch
    norm, where the weights hold one), a linear last layer."""
    layers = sum(1 for k in weights
                 if k.startswith('layers/') and k.endswith('/w'))
    for i in range(layers):
        x = x @ weights['layers/%d/w' % i] + weights['layers/%d/b' % i]
        if i == layers - 1:
            break
        if 'bn/%d/gamma' % i in weights:
            scale = weights['bn/%d/gamma' % i] / torch.sqrt(
                weights['bn/%d/var' % i] + EPS)
            x = x * scale + (weights['bn/%d/beta' % i] -
                             weights['bn/%d/mean' % i] * scale)
        x = torch.relu(x)
    return x


def frame_scores(eeg, audio1, audio2, weights: dict, lags: dict,
                 dtype=torch.float32):
    """(s1, s2): [n] scores of talker 1 and talker 2 for every frame a
    server emits from streams of n + post frames (the last frames lack
    their future context and are never emitted)."""
    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype)
    w = {k: tensor(v) for k, v in weights.items()}
    emitted = len(eeg) - max(lags['eeg_post'], lags['audio_post'])
    prediction = predict(lag_stack(tensor(eeg), lags['eeg_pre'],
                                   lags['eeg_post']), w)
    out = []
    for audio in (audio1, audio2):
        corr = ((tensor(audio) - w['corr_mean_x']) *
                (prediction - w['corr_mean_y']) / w['corr_power'])
        s = w['lda_slope'] * (corr @ w['lda_w'])[:, 0] + w['lda_intercept']
        out.append(s[:emitted])
    return out[0].double().numpy(), out[1].double().numpy()


def window_means(scores: np.ndarray, width: int, step: int) -> np.ndarray:
    """Means of frames [i * step, i * step + width) of every whole
    window."""
    count = 0 if len(scores) < width else (len(scores) - width) // step + 1
    return np.array([np.mean(scores[i * step:i * step + width])
                     for i in range(count)])


def wta(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Winner-take-all: talker 1 where its window mean is larger."""
    return c1 > c2
