"""Plain reference of a served deep CCA (DCCA) attention decoder.

Straight-line torch in float64 (or float32) with TF32 off, importing
nothing of the port and no JAX, from a session's raw frames and the
decoder's weights to every window's two means and its winner-take-all
decision:

  x1_t = [eeg[t - pre], ..., eeg[t + post]]           (zeros before 0)
  x2_t = [audio[t - pre2], ..., audio[t + post2]]     (each talker)
  h    = tower(x): ReLU(x W0 + b0) ... then a linear last layer
  r1_t = (h1_t - mean1) @ rot1,  r2_t = (h2_t - mean2) @ rot2
  s_t  = slope * sum_d lda_w[d] (r1_td - cmx_d)(r2_td - cmy_d) / p_d
         + intercept
  c_i  = mean of s over frames [i * step, i * step + width)
  talker 1 attended where c1_i > c2_i

The architecture is Andrew, Arora, Bilmes and Livescu, "Deep Canonical
Correlation Analysis", ICML 2013. Departures from the paper:

  * ReLU hidden layers, where the paper uses its own sigmoid (the
    inverse of x ** 3 / 3 + x); the last layer is linear, as there.
  * The towers take lag-stacked frames (temporal context), and one audio
    tower serves both talkers with the same weights.
  * The weights here are given (the tests seed them); the package trains
    the towers by minibatch Adam on the paper's objective, where the
    paper uses full-batch L-BFGS, and then fits the closed-form linear
    CCA of the tower outputs, as the paper does.
  * Evaluation is not the paper's total correlation: each frame's
    normalised products of the canonical components are reduced by a
    scaled LDA to one score, scores are averaged over windows, and the
    larger window mean of the two talkers wins.

``weights`` holds the model's parameters under their weights.npz names
(``tower1/0/w`` [in, out], ``tower1/0/b`` [out], ..., ``mean1``,
``mean2`` [1, D], ``rot1``, ``rot2`` [D, D]) and the decoder's
statistics and LDA (``corr_mean_x``, ``corr_mean_y``, ``corr_power``
[D], ``lda_w`` [D, 1], ``lda_slope``, ``lda_intercept``).
"""

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def lag_stack(x: torch.Tensor, pre: int, post: int) -> torch.Tensor:
    """[n, C] -> [n, (pre + 1 + post) C]: row t holds frames t - pre to
    t + post, lag by lag, zeros outside the stream."""
    n, channels = x.shape
    rows = torch.zeros((n, pre + 1 + post, channels), dtype=x.dtype)
    for i, lag in enumerate(range(-pre, post + 1)):
        lo, hi = max(0, -lag), min(n, n - lag)
        rows[lo:hi, i] = x[lo + lag:hi + lag]
    return rows.reshape(n, -1)


def tower(x: torch.Tensor, weights: dict, index: int) -> torch.Tensor:
    """Tower ``index`` (1: EEG, 2: audio): ReLU hidden layers, a linear
    last layer."""
    layers = sum(1 for k in weights if k.startswith('tower%d/' % index)
                 and k.endswith('/w'))
    for i in range(layers):
        w = weights['tower%d/%d/w' % (index, i)]
        b = weights['tower%d/%d/b' % (index, i)]
        x = x @ w + b
        if i < layers - 1:
            x = torch.relu(x)
    return x


def frame_scores(eeg, audio1, audio2, weights: dict, lags: dict,
                 dtype=torch.float64):
    """(s1, s2): [n] scores of talker 1 and talker 2 for every frame a
    server emits from streams of n + max(post, post2) frames (the last
    frames lack their future context and are never emitted)."""
    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype)
    w = {k: tensor(v) for k, v in weights.items()}
    emitted = len(eeg) - max(lags['eeg_post'], lags['audio_post'])
    x1 = lag_stack(tensor(eeg), lags['eeg_pre'], lags['eeg_post'])
    r1 = (tower(x1, w, 1) - w['mean1']) @ w['rot1']
    scale = w['lda_slope'] * w['lda_w'][:, 0] / w['corr_power']
    out = []
    for audio in (audio1, audio2):
        x2 = lag_stack(tensor(audio), lags['audio_pre'], lags['audio_post'])
        r2 = (tower(x2, w, 2) - w['mean2']) @ w['rot2']
        corr = (r1 - w['corr_mean_x']) * (r2 - w['corr_mean_y'])
        out.append((corr @ scale + w['lda_intercept'])[:emitted])
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
