"""Plain reference of VLAAI served as a two-talker attention decoder
(Accou, Vanthornhout, Van hamme and Francart, "Decoding of the speech
envelope from EEG using the VLAAI deep neural network", Sci. Rep. 2023;
https://github.com/exporl/vlaai, ``vlaai.py``).

Straight-line torch in float64 (or float32) with TF32 off, importing
nothing of the port and no JAX, from a session's raw frames and the
weights to every window's two means and its winner-take-all decision.
E is [T, C] of EEG:

  Conv1D(h)   y[t, o] = b[o] + sum_{k<K} sum_c h[t + k, c] W[k, c, o]
              ("valid", stride 1: T - K + 1 rows)
  LN(h)       (h - mean_c h) / sqrt(var_c h + 1e-3) * gamma + beta
  LReLU(h)    h where h > 0, else 0.3 h
  X(h)        five layers h <- pad_end_{K-1}(LReLU(LN(Conv1D(h)))): K - 1
              zero rows after the activation; one set of weights
  D_i(h)      h W_i + b_i, one dense layer a block
  O(h)        LReLU(LN(Conv1D_{K=32}(pad_start_31(h)))): 31 zero rows in
              front; one set of weights
  x_0 = 0,  x_i = O(D_i(X(E + x_{i-1}))),  pred = x_blocks W_out + b_out
  c_tk        (y_k[t] - cmx) (pred_t - cmy) / p       (talker k's envelope)
  s_tk        slope * c_tk * lda_w + intercept        (scaled LDA, D = 1)
  c_ik        mean of s_k over frames [i * step, i * step + width)
  talker 1 attended where c_i1 > c_i2

The served stream's prediction of frame t is the network's output at
frame t of the whole stream with ``pre`` zero frames in front (pre = the
blocks' 31 frames of output context each), which is what this computes:
one forward pass over the zero-prefixed stream, the last ``post`` frames
never emitted (pre + post, the blocks' 35 + 31 frames each, is the
window a frame's prediction reads).

Departures from the public code: none in the network (Keras's
LayerNormalization and LeakyReLU defaults, eps 1e-3 and slope 0.3, are
written out). The two-talker correlation and LDA around it are the
toolbox's regression decoder's, not the paper's; the paper's own
evaluation correlates one talker's envelope over whole segments.

``weights`` holds the network's parameters under their weights.npz
names (``extractor/j/{w [K, C_in, C_out], b, gamma, beta}``,
``dense/i/{w, b}``, ``context/{w, b, gamma, beta}``, ``output/{w, b}``)
and the decoder's statistics and LDA (``corr_mean_x``, ``corr_mean_y``,
``corr_power`` [1], ``lda_w`` [1, 1], ``lda_slope``, ``lda_intercept``).
"""

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EPS = 1e-3
SLOPE = 0.3


def counts(weights: dict):
    """(extractor layers, blocks) of a weights dict."""
    layers = sum(1 for k in weights
                 if k.startswith('extractor/') and k.endswith('/w'))
    blocks = sum(1 for k in weights
                 if k.startswith('dense/') and k.endswith('/w'))
    return layers, blocks


def context(weights: dict):
    """(pre, post): the frames before and after a frame its prediction
    reads."""
    layers, blocks = counts(weights)
    post = sum(weights['extractor/%d/w' % j].shape[0] - 1
               for j in range(layers))
    return blocks * (weights['context/w'].shape[0] - 1), blocks * post


def layer(h, w, b, gamma, beta):
    """LReLU(LN(Conv1D(h))) of [T, C_in] by w [K, C_in, C_out]."""
    y = F.conv1d(h.T[None], w.permute(2, 1, 0), b)[0].T
    mean = y.mean(dim=1, keepdim=True)
    var = ((y - mean) ** 2).mean(dim=1, keepdim=True)
    y = (y - mean) / torch.sqrt(var + EPS) * gamma + beta
    return torch.where(y > 0, y, SLOPE * y)


def network(e: torch.Tensor, w: dict) -> torch.Tensor:
    """[T, C] -> [T, outputs]: the forward pass over a whole stream."""
    layers, blocks = counts(w)
    x = torch.zeros_like(e)
    for i in range(blocks):
        h = e + x
        for j in range(layers):
            p = 'extractor/%d/' % j
            k = w[p + 'w'].shape[0]
            h = layer(h, w[p + 'w'], w[p + 'b'], w[p + 'gamma'],
                      w[p + 'beta'])
            h = torch.cat([h, torch.zeros((k - 1, h.shape[1]),
                                          dtype=h.dtype)])
        h = h @ w['dense/%d/w' % i] + w['dense/%d/b' % i]
        k = w['context/w'].shape[0]
        h = torch.cat([torch.zeros((k - 1, h.shape[1]), dtype=h.dtype), h])
        x = layer(h, w['context/w'], w['context/b'], w['context/gamma'],
                  w['context/beta'])
    return x @ w['output/w'] + w['output/b']


def predict(eeg, weights: dict, dtype=torch.float64) -> torch.Tensor:
    """[n - post] predictions of a stream of n frames: the network over
    the stream with ``pre`` zero frames in front."""
    w = {k: torch.as_tensor(np.asarray(v), dtype=dtype)
         for k, v in weights.items() if '/' in k}
    pre, post = context(weights)
    e = torch.as_tensor(np.asarray(eeg), dtype=dtype)
    e = torch.cat([torch.zeros((pre, e.shape[1]), dtype=dtype), e])
    return network(e, w)[pre:e.shape[0] - post, 0]


def frame_scores(eeg, audio1, audio2, weights: dict, dtype=torch.float64):
    """(s1, s2): the scores of talker 1 and talker 2 of every frame a
    server emits from streams of n frames (all but the last ``post``)."""
    prediction = predict(eeg, weights, dtype)
    emitted = len(prediction)
    out = []
    for audio in (audio1, audio2):
        y = torch.as_tensor(np.asarray(audio)[:emitted, 0], dtype=dtype)
        corr = ((y - float(weights['corr_mean_x'][0])) *
                (prediction - float(weights['corr_mean_y'][0])) /
                float(weights['corr_power'][0]))
        s = (weights['lda_slope'] * float(weights['lda_w'][0, 0]) * corr +
             weights['lda_intercept'])
        out.append(s.double().numpy())
    return out[0], out[1]


def window_means(scores: np.ndarray, width: int, step: int) -> np.ndarray:
    """Means of frames [i * step, i * step + width) of every whole
    window."""
    count = 0 if len(scores) < width else (len(scores) - width) // step + 1
    return np.array([np.mean(scores[i * step:i * step + width])
                     for i in range(count)])


def wta(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Winner-take-all: talker 1 where its window mean is larger."""
    return c1 > c2
